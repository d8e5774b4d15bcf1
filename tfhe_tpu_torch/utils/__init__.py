"""Host utilities: the CSPRNG and the native-library builder."""
