"""Core crypto on the host (numpy): parameters, entities, key generation,
encryption."""
