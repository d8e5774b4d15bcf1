"""integer on PyTorch: arbitrary-precision encrypted integers as radix
vectors of shortint blocks (port of tfhe_tpu.integer).

Host orchestration over the port's shortint entry points: every op is a
series of rounds of ``shortint.ServerKey.apply_lookup_table_batch`` (K1,
then K2 or K3 on the card), the same rounds with the same tables in the
same order as tfhe_tpu, so every block gives tfhe_tpu's words.  Round
outputs stay on the device; the linear algebra between rounds is gathered
there by the next round.
"""

from ..shortint.params import DEFAULT_PARAMS
from .ciphertext import BooleanBlock, RadixCiphertext, SignedRadixCiphertext
from .client_key import ClientKey
from .crt import CrtCiphertext, crt_reconstruct
from .server_key import ServerKey


def gen_keys(params=DEFAULT_PARAMS, seed=None, device="cuda"):
    ck = ClientKey(params, seed)
    return ck, ServerKey(ck, seed, device=device)
