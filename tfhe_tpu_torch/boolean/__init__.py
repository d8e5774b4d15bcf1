"""boolean on PyTorch: the original TFHE gate API (and/nand/or/nor/xor/xnor/
not/mux; port of tfhe_tpu.boolean).

Ciphertexts encode true/false as +-q/8 on the u64 torus; each binary gate is
one linear combination followed by a sign-extracting KS -> PBS on the shared
u64 exact pipeline (K1, then K2's exact rotation on the card), with gate
batches evaluated in one call (`*_packed` methods).  Trivial ciphertexts
short-circuit (boolean/ciphertext Trivial variant).
"""

from .client_key import Ciphertext, ClientKey
from .params import DEFAULT_PARAMETERS, TEST_PARAMETERS
from .server_key import ServerKey


def gen_keys(params=DEFAULT_PARAMETERS, seed=None, device="cuda"):
    ck = ClientKey(params, seed)
    return ck, ServerKey(ck, seed, device=device)
