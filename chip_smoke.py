#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tfhe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

From the root of a checkout, on a machine with one CUDA card and nvcc
(/usr/local/cuda/bin is searched too).  Phases, one JSON line each:

  1. the card (nvidia-smi name and power limit) and the torch, CUDA and nvcc
     versions;
  2. build the hand-written kernels from tfhe_tpu_torch/csrc/ (nvcc,
     sm_90a, one compiler per source, started together), and start the
     test vectors' CPU emission in a process of its own (phase 30); then every
     source again under ``nvcc -Xptxas -v`` for each kernel's registers,
     spills and shared memory (line "ptxas", printed after phase 13, the
     compilers running beside phases 3-13), with the rounded-key
     kernels' dynamic shared memory and ciphertexts a block;
  3. keygen at V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 (floored
     BSK, so the server key runs the v7 blind rotation, on a three-prime
     rounded key built on the card) and key upload;
  4. serve: three rounds of ServerKey.apply_lookup_table_batch at B = 512
     with LUT (3x+1) % 16, then one chained round on the device-resident
     outputs, profiled after a warm-up run of it; every output is
     decrypted and checked; every K1 launch must be its tensor-core
     kernel's;
  5. keygen_compression: CompressionKey at
     V1_4_COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 from phase 3's
     client key (decompression key floored at rb = 15, so decompression
     runs K2 in v7 mode; the packing key's byte layout for K4's
     tensor-core kernel built on the card);
  6. compress: the chained round's 512 device-resident outputs into 2
     storage GLWEs, one launch of K4's tensor-core kernel, then a second,
     warm call on the same list, which must give the same words;
  7. decompress: all 512 slots through one v7 launch of K2 at n = 1024
     (the function of tfhe_tpu's v8 kernel), every output decrypted, then a
     subset across the GLWE boundary;
  8. keygen_multibit at
     V1_4_PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
     (multi-bit key floored at rb = 18, so the server key runs the v9
     multi-bit blind rotation);
  9. serve_multibit: the rounds of phase 4 on the multi-bit key, through K1
     (its tensor-core kernel) and K3 (K2 never);
 10. modswitch_compress: switch_modulus_and_compress of 512 ciphertexts (K1
     each), then decompress_and_apply_lookup_table_batch with (3x+1) % 16,
     on the classic key (K2 once, exact mode on the unrounded key: its
     lazy exact kernel) and on
     the multi-bit key (K3 once, exact mode); every output decrypted;
 11. keygen_squashing: NoiseSquashingPrivateKey and NoiseSquashingKey at
     V1_4_NOISE_SQUASHING_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 over
     phase 3's client key (6-prime NTT key built and kept on the card);
 12. squash: the chained round's 512 device-resident outputs through
     squash_ciphertext_noise_batch (K1 once, then K5, the u128 blind
     rotation, once), every output decrypted under the squashing key, then
     a second, warm call;
 13. stepwise: the exact rotation one CMux step a launch through K2's
     single-step entry (blind_rotate_stepwise, the path of tfhe_tpu's
     build_cmux_step kernel; K2's lazy exact kernel at n_steps = 1) at the
     2_2 shape on a random key, B = 512;
 14. integer: the integer layer on phase 3's key (no second keygen),
     FheUint64 (32 blocks) add, sub, mul, eq, gt, bitand, scalar_mul and
     if_then_else (K1's tensor-core kernel, then K2 v7, every round), each
     timed after a warm-up op with its rounds, the batch size of each, PBS,
     launches and host materialisations (add and mul also profiled: their
     kernels' device seconds); FheUint8 add, mul and a cast; the
     scheduler's add_many and eq_many on 16 FheUint64 pairs (rounds of up
     to 512), with PBS/s;
 15. integer_multibit: FheUint64 add and mul on phase 8's key (K1, then K3
     v9; K2 never), reported as phase 14's;
 16. integer_storage: phase 14's FheUint64 sum through
     switch_modulus_and_compress (K1 a block) and decompress (K2's lazy
     exact kernel once, 32 blocks), then squashed on phase 11's key (K1,
     then K5 at B = 32) and decrypted with the squashing private key;
 17. boolean: keygen at DEFAULT_PARAMETERS, one AND gate, 512 packed gates
     across the six kinds (gates/s) and one mux, each timed after a
     warm-up call; K2's lazy exact kernel once a gate call, every K1
     launch its tensor-core kernel's;
 18. hlapi: generate_keys at DEFAULT_PARAMS with noise squashing (V1_4),
     set_server_key, FheUint64 add, mul, lt, FheBool &, if_then_else and a
     scalar add (K1's tensor-core kernel, then K2 v7, every round), each
     timed after a warm-up op beside the integer phase's seconds for the
     same op, the add's words against the integer layer's, and squash_noise
     of a FheUint64 (K1, then K5 at B = 32);
 19. oprf: the compute key's exact key, FheUint64 OPRF draws (K2's lazy
     exact kernel once each, no K1) twice from one seed (the same words), a
     16-bit bounded draw, bitonic_shuffle of 8 FheUint16 values;
 20. compressed_key: a CompressedServerKey on phase 18's client key (its
     stored bytes against the full key's, keygen and decompress seconds; v7
     mode on the floored key) and one FheUint64 add under it;
 21. kv_store: a KVStore of 128 clear u32 keys to FheUint64 values, get of
     a present and of an absent encrypted key, one update (rounds, the
     largest round's B, PBS/s); an FheUintArray add of 16 FheUint32 pairs;
 22. strings: FheAsciiStrings: eq of a 16-character string and one of 4
     characters and 4 hidden nul pads, contains and find of a 3-character
     pattern and to_uppercase of the first, trim of the second, split(".")
     of a 3-character one, held to Python's str, with rounds and PBS;
 23. compact_pke (config 5): on phase 18's keys, the V1_4 ZKV2 PKE private
     and public keys and both casting keys (keygen seconds each), a v2 CRS
     for 32 slots, two proven lists of one FheUint64 each (prove seconds a
     list), each verified and expanded (one batched extraction), the 64
     slots cast to the small key in one call (K1's tensor-core kernel at
     n_in = 2048, l = 4, then K2's lazy exact kernel on the exact key) and
     the two FheUint64 added through the hlapi (against (x + y) mod 2^64);
     a plain list of 2048 slots expanded and cast at B = 2048 (slots per
     second); the first list's slots cast to the big key (K1's limb-row
     kernel, base 2^24, l = 1; no generic K1 launch); re-randomization of 32 ciphertexts; every
     slot decrypted; tfhe-rs's CPU figures for one proven FheUint64 beside
     the port's;
 24. trivium: Trivium and Kreyvium on phase 17's boolean keys from the
     encrypted post-warm-up state of a clear stream: 8 keystream steps and
     8 transciphered bits each, held against the clear stream, with
     seconds and gate calls a step (K1's tensor-core kernel, then K2's
     lazy exact kernel, once a gate call) and the projected warm-up;
 25. atomic_patterns: the remaining shortint atomic patterns through the
     ServerKey at full width, each set with its keygen seconds, three
     rounds at B = 512 (PBS/s) and one at B = 32 through the same entry
     point with every kernel wrapper swapped for its plain version (0 words
     differing): KS32 at V1_4_PARAM_MESSAGE_2_CARRY_2_KS32_PBS_TUNIFORM_2M128
     (K1-32's tensor-core kernel on the u32 key's 4-limb byte layout, its
     bytes against the 64-bit key's, then K2 v7; many-LUT on it, K2's lazy
     exact kernel), PBS->KS at
     V1_4_PARAM_MESSAGE_2_CARRY_2_PBS_KS_GAUSSIAN_2M128 (K2's lazy exact
     kernel, then K1 at n_in = 2048, l = 6), the KS_PBS sets 2M64, 2M40 and
     Gaussian 2M128 (K1, K2 v7), TEST KS32 and TEST PBS->KS (both decrypted;
     the two V1_4 sets above decrypt at random in tfhe_tpu too, ROADMAP.md
     queue 3: their words are checked), many-LUT with two functions on
     phase 3's classic key (K1, K2's lazy exact kernel) and phase 8's
     multi-bit key (K1, K3 exact), and the drift modulus switch on the TEST
     set (16 zeros; the float32 choice on the card at B = 512 against the
     host's);
 26. wire: at DEFAULT_PARAMS, the client (host, this process) makes its
     keys and a seeded server key, encrypts two FheUint64s and serializes
     them (utils/serialization.py, tfhe_tpu's format); the server
     deserializes the key, decompresses it onto the card (v7 mode), adds,
     stores the sum modulus-switched on the wire, reads it back (K2's lazy
     exact kernel once) and serializes the result; the client decrypts it;
     each step's seconds and payload bytes;
 27. squash_compress: V1_4 squashed-noise compression keygen over phase
     11's squashing key (n = 4096 into k_out = 6, N_out = 1024, 128 slots a
     GLWE; seconds, the key's bytes on the card), the first 128 of phase
     12's squashed outputs compressed (K6 once) and decrypted with
     decrypt_list on the host, phase 14's FheUint64 sum squashed and its 32
     blocks compressed, all 512 as 4 lists in one K6 launch, cold and warm
     (the same words), stored bytes against the squashed lists' bytes;
 28. wopbs: TEST_PARAM_MESSAGE_2_CARRY_2 with TEST_WOPBS_PARAM (the only
     WoPBS sets either package has): keygen, extract_bits, apply_wopbs with
     the identity and a non-monotone LUT over all 16 inputs (K1, K2's
     small-N cluster kernel, K1 at the PFPKS shape once a call on its
     limb-row kernel, no generic K1 launch, K2's CMux chain once a call
     for the low bits), a 10-bit vertical packing (K2's
     CMux entry once, on the small-N cluster kernel's CMux mode; the chain
     once; the step entry never);
 29. aes: at the same sets, the S-box of 4 encrypted bytes and one AES-128
     round with injected encrypted round keys against the cleartext model
     (every packing of a table in one chain launch: 1 and 3);
 30. test_vectors: toy_params and valid_params_128 emitted on the card (K1,
     K2's exact kernels) and compared byte for byte with phase 2's CPU
     emission;
 31. serve_3_3: V1_4_PARAM_MESSAGE_3_CARRY_3_KS_PBS_TUNIFORM_2M128 (n =
     1077, N = 8192, l = 2) through the entry points: keygen on the card
     (seconds; the NTT key's 1.13 GB, the keyswitch key's words and byte
     limbs), three rounds at B = 64, every output decrypted (K1's
     tensor-core kernel at n_in = 8192, then K2's cluster kernel once a
     round: a cluster of four blocks a ciphertext, one a CRT prime), and a
     radix of 4 blocks' add and mul through the integer layer;
 32. param_sets: the sets of shortint/params.py that had never had a
     real-key round on the card (1_1: K2's small-N cluster
     kernel at k + 1 = 5; the GPU multi-bit GROUP_2 at N = 4096 and GROUP_3
     at l = 2: K3's cluster kernel; GROUP_4 1_1: K3 v9): keygen, one round
     at B = 32 and a warm round on the same inputs, decrypted, and its
     first 4 inputs through the same entry point with the kernels and with
     their plain versions (each counted; no generic exact kernel);
 33. research_primitives: the GLWE keyswitch, the common mask and the
     experimental core at the 2_2 widths (n = 918, k = 1, N = 2048), keygens
     on the card from fixed seeds, every output decrypted: the GLWE
     keyswitch of 512 GLWEs (K7's cluster kernel, base 2^8 x 4), the fast
     keyswitch of 512 GLWEs from a k_in = 2 partial key on a pseudo-GGSW
     (K7's cluster kernel with the sum added), the shrinking keyswitch 2048 -> 918 (K1), the CM keyswitch and
     CM packing 2048 -> 918 at C = 3 (K1), the CM bootstrap of 64 CmLwes
     at C = 3 (K2's cluster kernel at k+1 = 4; the CM bootstrap key's 481
     MB), at C = 4 with keys of its own (the cluster kernel at k+1 = 5,
     which no block of the generic kernel holds) and one at C = 1 (K2's
     lazy kernel), the CM CMux of 64 CM GLWE pairs at C = 3, 4 and 7 and
     the CM external product at C = 3 (K2's CMux entry on the N = 2048
     cluster kernel's CMux mode, which the card refused at C >= 4 before;
     every slot decrypted, every word against server.cmux), the extended PBS of 64 LWEs at E = 1, 2 and 4 on phase
     3's exact key (K8's lazy kernel; at E = 1 the words of K2's exact
     rotation); each rotation's route, a block's shared memory and the
     clusters the card holds at once (cudaOccupancyMaxActiveClusters);
 34. each kernel against its plain PyTorch version, bit-exact: K1 keyswitch
     (the tensor-core kernel at both keyswitch shapes) on both paths' own
     B = 512 inputs, at phase 10's B = 1 and at B = 513 on both keys, its
     generic kernel at B = 512 on both keys, and phase 10's 512 stored
     values on each key against the plain
     keyswitch and modulus switch; K2 on the classic path's B = 512 inputs
     in v7 mode (the rounded-key route against the plain three-prime
     rotation) and in exact mode (unrounded key, which must differ from
     the rounded one), with phase 10's classic outputs against the plain
     rotation, and at B = 4 over the full n = 918 in both modes, in v7 mode
     also against the four-prime v7 rotation on round_bsk(bsk, 15), and in
     exact mode on that four-prime rounded key (the function of tfhe_tpu's
     v3/v4 kernels), and in exact mode for k + 1 = 2, l = 2 on a random
     key (its generic instance), the lazy exact kernel at the ragged
     batches B = 1, 3, 513 over 64 steps of the unrounded key, the generic
     exact kernel at the production shape on the same B = 512 inputs (the
     kernel the lazy one replaced), K2 at the TEST shape (N = 512) and at
     1_1's k + 1 = 5, N = 512 on random keys (the small-N cluster kernel
     at both); v7 mode must refuse a four-prime key on
     the card; the v7 route at the ragged batches B = 1, 3, 5, 513 over
     64 steps and on a four-prime rounded key (rb = 4, the CRT bound's
     fallback); K2 in v7
     mode at the decompression shape (n = 1024) on all 512 of phase 7's
     inputs and on its B = 3 subset (also against the four-prime v7
     rotation), with phase 7's outputs against the plain rotation; K3 on
     the multi-bit path's own B = 512 inputs in v9 mode (the first 4 also
     against the four-prime v9 rotation on the rounded key; the ragged
     batches over 8 groups; a four-prime rounded key) and in exact mode
     (unrounded key; the ragged batches over 8 groups of it), with phase
     10's multi-bit outputs against the plain rotation, at tfhe_tpu's
     GROUP_2 shape (g = 2, n = 918) on random keys in exact mode and in
     v9 mode (a rounded key, four patterns a group), and its cluster kernel at the GROUP_3 shape (l = 2) in
     exact mode, where v9 mode must refuse a rounded and a four-prime key;
     K4 on phase 6's 512 inputs (its tensor-core kernel, the generic
     kernel it replaced and the int8 torch._int_mm yardstick; a bare int64
     key must be refused), at B = 4096 on the same key, on an all-ones key
     with masks of the largest digits at B = 512 and at B = 33792 (3072
     rows a block summed in s32), and at K4_SHAPES on random keys (each
     shape on the kernel its shape takes, the tensor-core kernel's shapes
     on the generic kernel too); K5 on phase 12's own 512 inputs against phase 12's outputs and,
     for the first K5_PLAIN_BATCH, against the plain u128 rotation, and at
     the TEST squashing shape (k + 1 = 2, N = 512) and a generic shape
     (k + 1 = 3, N = 1024, l = 2: the generic kernel) on random keys, and
     at the ragged batches over the squashing key's first 16 steps; K2's
     step entry: phase 13's rotation against the whole K2 rotation and
     the plain one, one step at B = 512 and at the ragged batches; times
     of each kernel in each mode, its plain version, the generic kernels
     of K1, K2's exact mode and K4 that the redesigned ones replaced at
     their shapes and, for K1 and K4, an int8-limb torch._int_mm
     formulation (K1's is the TPU's; yardsticks the port never calls);
     phase 14's FheUint64 mul product round (B = 1024): its first 8
     inputs through K1 and K2 v7 against the plain keyswitch and
     three-prime v7 rotation, and the round's outputs against the plain
     path; phase 17's 512 packed gate inputs through K1 and K2's lazy exact
     kernel against the plain keyswitch and exact rotation, and the gates'
     outputs against the plain path; K2's generic exact kernel at
     tfhe_tpu's TFHE_LIB_PARAMETERS shape (k + 1 = 2, N = 1024, l = 3,
     n = 630) on a random key at B = 4 and B = 3; K2's lazy exact kernel on
     phase 19's OPRF inputs and LUTs (B = 32), and phase 22's first round
     through K1 and K2 v7; phase 23's casts: K1 at both cast shapes (its
     tensor-core kernel at B = 64 and 2048, its limb-row kernel at B = 32,
     timed in turns with the generic kernel it replaced there, through
     its C entry alone and against 26 int8 torch._int_mm GEMMs of byte
     limbs) against the plain keyswitch, K2's lazy exact kernel on the B = 64
     cast's switched inputs against the plain exact rotation, and the cast
     outputs against the plain path; K1-32 (its tensor-core kernel, its
     generic kernel and the int8 torch._int_mm yardstick) at both KS32
     shapes on B = 512 encryptions and at B = 1 and 513, and phase 25's
     plain comparisons, and its contraction whole (one slice a block, the
     grid before the split); K6 against its plain version (the 8-prime
     CRT-NTT)
     on phase 27's key and inputs at 1, 16 and 128 slots and on masks of
     the extreme digits +-2^60, and at the TEST shape on a random key;
     K2's cluster kernel on phase 31's first 4 switched inputs over the
     real 3_3 key and on a random key at that shape over 64 steps at B = 1,
     3 and 4; K1
     at the PFPKS shape on phase 28's circuit-bootstrap LWEs (its limb-row
     kernel at B = 1, 3 and 40, timed as the cast's, the yardstick 21
     GEMMs); K2's CMux entry (its small route) against server.cmux at B =
     1 and 64, in turns with its generic kernel; K7 at both signs on phase 33's inputs and keys (its cluster kernel
     at B = 3 and 512, timed in turns with its first kernel, and the int8
     torch._int_mm GEMMs of the digits by the key's negacyclic Toeplitz),
     K1 at the shrinking and CM shapes on phase 33's inputs (with the
     int8-limb torch._int_mm yardstick), K8's lazy kernel at E = 1, 2, 4 and 8 (at
     each E also at each of its slots a block, SB <= E; every SB that
     phase 33 ran must be among them), its generic kernel at l = 2 (the
     shape still routed to it), K2's cluster kernel at the CM shapes k+1 = 3, 4, 5 and 8 and its generic kernel at
     k+1 = 4, at B = 4 over 64 steps of a random key, and its CMux entry
     there (the cluster route; the generic kernel at k+1 <= 4) on a random
     GGSW, with phase 33's CM CMux outputs; K2 at the TEST
     shapes (N = 512) at each shape and batch phases 28-29 launched it
     with, the route's kernel and the generic kernel's C entry in turns,
     timed beside their bounds; K2's small-N cluster kernel at the TEST
     rotation shape (B = 4, 128, 512; and l = 2, 3 at B = 3; k + 1 = 3, 4
     at B = 3) and its CMux
     chain (three GGSW sets, a ragged key_index, B = 1 and 64) against the
     plain versions and, in turns, the generic kernel's C entry; phase 32's
     new routes on their real keys and the rounds' own keyswitched inputs
     at B = 4 and 32 (K2's small-N kernel at 1_1, K3's cluster kernel at
     GPU GROUP_2 and GROUP_3) against the plain rotations and, in turns,
     the generic kernels' C entries;
 35. the launch counts of phases 4, 6, 7, 9, 10, 12-24 and 27-33 (each
     wrapper's and, of them, those of K1's and K4's tensor-core kernels and
     K2's lazy exact kernel), the script's total seconds and one
     {"kernels": [...]} line (K1-32's entry, keyswitch32, with the
     launches of phases 25-26 on every kernel's; K6's, K1's limb-row
     kernel's (the PFPKS of phases 28-29 and phase 23's cast to big, by
     path) and the CMux entry's, with the launches of phases 28-30 on K1's,
     K2's exact kernels' and the step entry's; K2's cluster kernel's, with
     the launches of phases 31-32 on K1's, K2's and K3's, phase 32's
     rounds, warm rounds and B = 4 checks each a path; K2's small-N kernel
     at 1_1 and K3's cluster kernel, phase 32's; K7's, K8's, and
     K2's and K1's at phase 33's shapes; K9's step entries and its fused
     entry, each with the launches of phase 37 by path).

Phases 36-38 run after phase 33, before phase 34:

 36. core_functions: at the 2_2 set, three chunks of 8 GGSWs of a
     bootstrap key (keygen.generate_lwe_bootstrap_key_chunk, the secret
     products on the card) against the same GGSWs of the whole key from a
     generator seeded alike; pseudo_random_lwe at 32 and 64 bits against
     the u32 and u64 draws of its stream;
 37. multi_device: on phase 3's key at the 2_2 widths, the batch mesh
     (parallel/mesh.py sharded_ks_pbs on the exact key, sharded_ks_pbs_mxu
     on the rounded key, K1 then K2 on each slot's shard) at B = 512 on a
     mesh of every visible card and on 4 slots of cuda:0, each twice from
     host-resident copies of the keys (one upload a distinct device on the
     first call, none on the second), against the unsharded ks_pbs_batch
     and decrypted, with seconds, PBS/s and the key bytes each device
     holds; the poly-sharded PBS (parallel/poly_shard.py
     sharded_ks_pbs_poly: K1, then K9's fused entry, the whole rotation in
     one launch, since every slot is cuda:0) at B = 1 and 4 over D = 1, 2
     and 4 slots of cuda:0, against K1 and K2's exact rotation (timed
     beside it), with seconds a PBS, K9's launches (one fused launch and no
     step-entry launch a call) and the host's share; the key's preparation
     (K9's entries a and b) and a sharded product (K9's three step
     entries), each counted; a FheUint8 add through the latency route
     (every round one PBS split over 4 slots), decrypted, with its rounds
     and seconds.
     One card measures no scaling across cards;
 38. c_api: c_api_torch/ built with gcc on the card's host (Python.h from
     sysconfig's include directory, libpython linked; build/c_api_torch/)
     and its test program run at config kind 1 (DEFAULT_PARAMS) on cuda,
     with its seconds a call.

Phase 34 also holds K9's three step entries (csrc/poly_shard.cu) against
their plain versions (ops/four_step.py) at D = 1, 2, 4 and B = 1, 4, N =
2048, on phase 3's key slices, each timed; and K9's fused entry against
its plain version (the step loop on the plain stages) at D = 1, 2, 4, 8
and B = 1, 4 on a random key cut to 64 steps (every slot in shared
memory), and at k+1 = 7, l = 3 over 4 steps at D = 1, 2, 4 (the state in
a global scratch, the tables and the key in global memory, the key
alone there).

Every torus comparison is exact (tolerance 0): all arithmetic on the path
is integer.  Any failure raises and exits non-zero; the last line
{"ok": true, "device": {...}} is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import atexit
import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s, int8 tensor cores
# 1979 TOP/s.  32-bit integer multiply-add on the CUDA cores: 64 per clock
# per SM (CUDA C++ programming guide, throughput table, compute capability
# 9.0) x 132 SMs x 1.98 GHz boost, half the data sheet's 67 TFLOP/s fp32
# rate counted in multiply-adds.
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
INT32_MUL_PER_S = 64 * 132 * 1.98e9

BATCH = 512
ROUNDS = 3
CHECK_BATCH = 4           # the random-input checks at full n
K2_GENERIC_LEVELS = 2     # l != 1 takes K2's generic (run-time shape) instance
# CRT primes the blind rotation needs on this key: three on the quotients of
# the 2^15-rounded key (tfhe_tpu's v7 kernel, tfhe_tpu/ops/mxu.py:253; K2's
# rounded-key route, ops/bsk_prep.py crt_prime_count), four for the exact
# rotation.  The bound counts what the function needs.
V7_PRIMES = 3
EXACT_PRIMES = 4
# tfhe_tpu's v9 kernel runs three primes on the rb-rounded multi-bit key
# (tfhe_tpu/shortint/server_key.py:183-203), as K3's rounded-key route does
V9_PRIMES = 3
# batches that the rounded-key kernels' C ciphertexts a block do not divide
# (or that leave the last block part-filled), and the steps (groups) of the
# key they run over, against the plain rotations
RAGGED_BATCHES = (1, 3, 5, 513)
RAGGED_STEPS = 64
RAGGED_GROUPS = 8
# tfhe_tpu's MXU four-step split N = N1 * N2 (tfhe_tpu/ops/mxu.py:8)
FOUR_STEP_N1 = 128
# CRT primes an exact packing keyswitch needs: |X| < 8 2^64 N n l < 2^88 at
# the production set, below half the product of three 30-bit primes
K4_PRIMES = 3
# K5 against its plain version on the first K5_PLAIN_BATCH of the squash
# phase's 512 inputs (the plain u128 rotation at B = 512 would take minutes),
# and at the TEST squashing shape (k + 1 = 2, N = 512: the generic instance)
# on a random key over K5_TEST_STEPS steps
K5_PLAIN_BATCH = 32
K5_TEST_STEPS = 64
# K5's generic kernel (the shapes off its lazy kernel's instances) at
# (k + 1, N, l, base_log) on a random key; and the steps of the squashing
# key's head that the ragged batches run over
K5_GENERIC_SHAPE = (3, 1024, 2, 20)
K5_RAGGED_STEPS = 16
# K2's generic exact kernel on random keys at (k + 1, N, l, base_log): the
# TEST sets' shape and 1_1's
K2_GENERIC_SHAPES = ((2, 512, 1, 23), (5, 512, 1, 23))
K2_GENERIC_STEPS = 64
# CRT primes the exact u128 product needs: 2^165.2 < P/2 takes six
K5_PRIMES = 6
# K2's single-step entry (blind_rotate_stepwise) on a random 2_2-shape key
STEPWISE_STEPS = 16
# K4 on random keys and inputs, (B, n, l, k+1, N, LWEs a GLWE, base_log):
# the tensor-core kernel's shapes (N = 256, k+1 <= 5, base_log <= 7) with a
# partial last GLWE, k+1 = 1, 2, 3 and 5, l = 1 to 4, GLWEs of 3 and 200
# LWEs, base_log 1, 4, 5 and 7; the generic kernel's at N = 32 and 1024
# and at N = 256 with 8-bit digits
K4_SHAPES = ((300, 512, 3, 2, 256, 256, 4), (45, 40, 2, 2, 32, 20, 5),
             (3, 5, 1, 1, 1024, 1000, 10), (37, 70, 3, 2, 256, 256, 4),
             (257, 64, 1, 5, 256, 256, 4), (700, 48, 2, 5, 256, 200, 5),
             (100, 33, 4, 3, 256, 256, 7), (5, 20, 1, 1, 256, 3, 1),
             (64, 30, 2, 2, 256, 256, 8))
# K4 at 16 GLWEs under the compression key (the same key as B = 512); and
# the extreme case on an all-ones key at a batch whose 132 GLWEs leave
# two coefficient ranges, 3072 rows, to each block of the tensor-core kernel
K4_BIG_BATCH = 4096
K4_GUARD_BATCH = 33792
# the integer phases: FheUint64 and FheUint8 at 2 bits a block; the
# scheduler's coalesced ops on BATCHED_PAIRS FheUint64 pairs; FheUint64
# mul's product round (its 32 x 33 / 2 lsb and 32 x 31 / 2 msb block
# products), of which K2 v7 runs the first MUL_ROUND_CHECK against the plain
# rotation; tfhe-rs's FheUint64 add and mul latency on one H100 (BASELINE.md)
U64_BLOCKS = 32
U8_BLOCKS = 4
BATCHED_PAIRS = 16
MUL_PRODUCT_ROUND = 1024
MUL_ROUND_CHECK = 8
TFHE_RS_H100_MS = {"add": 9.52, "mul": 31.9}
# the boolean phase: packed gates across the six kinds; K2's generic exact
# kernel at tfhe_tpu's TFHE_LIB_PARAMETERS shape (k + 1, N, l, base_log, n)
# on a random key at two batches
GATES = 512
GATE_KINDS = ("and", "or", "xor", "nand", "nor", "xnor")
GATE_FNS = {"and": lambda x, y: x and y, "or": lambda x, y: x or y,
            "xor": lambda x, y: x != y, "nand": lambda x, y: not (x and y),
            "nor": lambda x, y: not (x or y), "xnor": lambda x, y: x == y}
TFHE_LIB_SHAPE = (2, 1024, 3, 7, 630)
TFHE_LIB_BATCHES = (4, 3)
# the high-level API's phases (hlapi keys at DEFAULT_PARAMS, V1_4 2_2): the
# FheUint64 ops and a scalar; the OPRF's draws and a bitonic shuffle of
# SHUFFLE_VALUES FheUint16s; a KVStore of KV_ENTRIES clear u32 keys (16
# blocks) to FheUint64 values, the size of a small encrypted lookup table,
# and an FheUintArray add of ARRAY_PAIRS FheUint32 pairs; an FheAsciiString
# of 16 characters (a name, a code) for eq, contains, find and
# to_uppercase with a 3-character pattern, one with STRING_PADS hidden nul
# pads for eq and trim, and a short one for split: a string op's rounds
# grow with its length (tfhe_tpu's order: per-character calls, each its own
# rounds at B <= 8), and trim (barrel shifts by a hidden count) and split
# (every field's extraction, O(n^2 log n) selects) at 16 characters would
# take some 1,700 and 20,000 rounds of about 30 ms each
HLAPI_SCALAR = 0x1234_5678_9ABC
SHUFFLE_VALUES = 8
KV_ENTRIES = 128
KV_KEY_BLOCKS = 16
ARRAY_PAIRS = 16
STRING_TEXT = "Grace.Hopper1906"
STRING_PADDED = " Ada"
STRING_PADS = 4
STRING_SPLIT = "A.B"
STRING_PATTERN = "per"
STRING_ROUND_CHECK = 8
HLAPI_PATHS = ("hlapi", "oprf", "compressed_key", "kv_store", "strings")
HLAPI_OPRF_STEPS = ("draw", "repeat", "bounded_16_bits", "bitonic_shuffle")
HLAPI_KV_STEPS = ("get_present", "get_absent", "update", "array_add")
HLAPI_STRING_OPS = ("eq", "contains", "find", "to_uppercase", "trim", "split")
# config 5 (BASELINE.json): compact lists under the V1_4 ZKV2 PKE set (d =
# 2048, TUniform(17)) cast into the hlapi keys; a v2 CRS for CRS_SLOTS slots
# (one FheUint64 at 2 bits a block), two proven lists of PKE_SLOTS slots, a
# plain list of PKE_FULL_SLOTS (N) slots; tfhe-rs's figures for one proven
# FheUint64 on a CPU (SURVEY.md:617).  The trivium phase: TRIVIUM_STEPS
# keystream steps, then as many transciphered bits, from the encrypted
# post-warm-up state of a clear stream (a warm-up is 4 x 288 steps)
CRS_SLOTS = 32
PKE_SLOTS = 32
PKE_FULL_SLOTS = 2048
PKE_METADATA = b"chip_smoke config 5"
TFHE_RS_ZK_CPU_MS = {"prove": 146.0, "verify": 31.2, "verify_and_expand": 51.1}
TRIVIUM_STEPS = 8
TRIVIUM_WARMUP_STEPS = 4 * 288
TRIVIUM_STREAMS = (("trivium", "TriviumStream", 80), ("kreyvium", "KreyviumStream", 128))
# every kernel of the port, by the name a profiler trace gives it
KERNEL_NAMES = ("keyswitch_kernel", "keyswitch_wide_kernel", "keyswitch_imma_kernel",
                "keyswitch_digits_kernel", "keyswitch_limbs_kernel",
                "keyswitch_limb_rows_kernel",
                "keyswitch32_kernel",
                "keyswitch32_imma_kernel", "blind_rotate_kernel", "cmux_kernel",
                "blind_rotate_cluster_kernel", "blind_rotate_cluster_small_kernel",
                "blind_rotate_exact_lazy_kernel", "blind_rotate_rounded_kernel",
                "blind_rotate_multibit_kernel", "blind_rotate_multibit_lazy_kernel",
                "blind_rotate_multibit_cluster_kernel",
                "blind_rotate_multibit_rounded_kernel", "blind_rotate128_kernel",
                "blind_rotate128_lazy_kernel", "packing_keyswitch_kernel",
                "packing_keyswitch_imma_kernel",
                "packing_keyswitch128_imma_kernel", "packing_keyswitch128_reduce_kernel",
                "glwe_keyswitch_kernel", "glwe_keyswitch_cluster_kernel",
                "blind_rotate_extended_kernel",
                "blind_rotate_extended_lazy_kernel", "ps_forward_kernel", "ps_cross_kernel",
                "ps_inverse_kernel", "ps_rotate_kernel")


STARTED = time.perf_counter()


def emit(obj) -> None:
    """Print obj as one JSON line; a phase line also gets the seconds since
    the script started (at_seconds: the time between two lines is the
    phase's)."""
    if "phase" in obj:
        obj = {**obj, "at_seconds": time.perf_counter() - STARTED}
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def nvcc_version(kernels) -> str:
    out = subprocess.run(kernels.nvcc_command()[:1] + ["--version"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_ms(fn, reps: int) -> tuple:
    """cuda_ms's figure (the mean milliseconds between two CUDA events
    around reps launches, after one warm-up) and the host's milliseconds to
    enqueue one of those launches: where the host's is the larger, the
    events time the host, not the kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """The device's milliseconds a launch of fn: reps calls captured in one
    CUDA graph, replayed (after a warm replay) replays times between two
    CUDA events, so the host's enqueue time is out of the figure."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def step_entry_probe(kernels, server, st_args) -> dict:
    """K2's step entry on phase 13's first step at B = 512, timed as the
    kernel table times it (10 launches) with the host's enqueue time a
    launch, and at 100 launches."""
    acc0 = server.initial_accumulator(st_args[2], st_args[1], False).contiguous()
    step_args = (st_args[0][:, 0], st_args[3][0]) + st_args[4:]
    ms10, host10 = launch_ms(lambda: kernels.cmux_step(acc0, *step_args), 10)
    ms100, host100 = launch_ms(lambda: kernels.cmux_step(acc0, *step_args), 100)
    return {"ms_10": ms10, "host_ms_10": host10, "ms_100": ms100, "host_ms_100": host100}


def max_abs_err(got, want) -> int:
    """Largest |got - want| of int64 torus words (the wrapped difference)."""
    return int((got - want).abs().max().item())


def int_mm_keyswitch(ct, ksk, base_log: int, levels: int):
    """The TPU's keyswitch formulation (tfhe_tpu/ops/server.py:157): the
    signed digits times 10 seven-bit limbs of the key, each an int8 GEMM
    (torch._int_mm), recombined mod 2^64.  A library yardstick for K1."""
    import torch
    from tfhe_tpu_torch.ops import server

    b = ct.shape[0]
    n_in, lev, m_out = ksk.shape
    digits = server.signed_decompose(ct[:, :-1], base_log, levels)
    d8 = digits.permute(1, 2, 0).reshape(b, -1).to(torch.int8)
    key = ksk.reshape(-1, m_out)
    pad = (-m_out) % 8
    acc = torch.zeros((b, m_out), dtype=torch.int64, device=ct.device)
    for e in range(10):
        limb = ((key >> (7 * e)) & 127).to(torch.int8)
        limb = torch.nn.functional.pad(limb, (0, pad))
        acc += torch._int_mm(d8, limb)[:, :m_out].to(torch.int64) << (7 * e)
    out = -acc
    out[:, -1] += ct[:, -1]
    return out


def generic_keyswitch(kernels, ct, ksk, base_log: int, levels: int):
    """K1's generic kernel (csrc/keyswitch.cu keyswitch_kernel) through its C
    entry: at the main path's shapes, the kernel the tensor-core kernel
    replaced."""
    import torch

    out = torch.empty((ct.shape[0], ksk.shape[2]), dtype=torch.int64, device=ct.device)
    err = kernels.load()["keyswitch"].tfhe_torch_keyswitch(
        out.data_ptr(), ct.data_ptr(), ksk.data_ptr(), ct.shape[0], ksk.shape[0], levels,
        ksk.shape[2], base_log, kernels._stream(ct))
    if err:
        raise RuntimeError(f"K1's generic kernel failed: cudaError {err}")
    return out


def generic_keyswitch32(kernels, ct, ksk, base_log: int, levels: int):
    """K1-32's generic kernel (csrc/keyswitch.cu keyswitch32_kernel, the u32
    twin of keyswitch_kernel) through its C entry."""
    import torch

    out = torch.empty((ct.shape[0], ksk.shape[2]), dtype=torch.int64, device=ct.device)
    err = kernels.load()["keyswitch"].tfhe_torch_keyswitch32(
        out.data_ptr(), ct.data_ptr(), ksk.data_ptr(), ct.shape[0], ksk.shape[0], levels,
        ksk.shape[2], base_log, kernels._stream(ct))
    if err:
        raise RuntimeError(f"K1-32's generic kernel failed: cudaError {err}")
    return out


def int_mm_keyswitch32(ct, ksk32, base_log: int, levels: int):
    """The KS32 keyswitch as int8 GEMMs (torch._int_mm): the signed digits
    times 4 signed byte limbs of each u32 key word (w = sum_j s_j 2^(8j) mod
    2^32, s_j in [-128, 127]), recombined mod 2^32.  A library yardstick for
    K1-32 (the TPU runs a wrapping u32 contraction, tfhe_tpu/ops/server.py:131)."""
    import torch
    from tfhe_tpu_torch.ops import server, torus

    b = ct.shape[0]
    m_out = ksk32.shape[2]
    digits = server.signed_decompose(ct[:, :-1], base_log, levels)
    d8 = digits.permute(1, 2, 0).reshape(b, -1).to(torch.int8)
    x = ksk32.reshape(-1, m_out)
    pad = (-m_out) % 8
    acc = torch.zeros((b, m_out), dtype=torch.int64, device=ct.device)
    for j in range(4):
        low = x & 255
        limb = low - 256 * (low >= 128).to(torch.int64)
        x = (x - limb) >> 8
        limb8 = torch.nn.functional.pad(limb.to(torch.int8), (0, pad))
        acc += torch._int_mm(d8, limb8)[:, :m_out].to(torch.int64) << (8 * j)
    out = -acc
    out[:, -1] += torus.shr(ct[:, -1], 32)
    return out & server.M32


def int_mm_limb_product(digits, words, base_log: int):
    """sum_k digits[:, k] words[k, :] mod 2^64 as int8 GEMMs (torch._int_mm):
    each signed digit |d| <= 2^(base_log-1) as ceil((base_log + 1) / 8)
    balanced byte limbs, each int64 word as 8 balanced byte limbs, the
    limb pairs t + j < 8 multiplied and recombined at 2^(8 (t + j)).  The
    yardstick's core for contractions whose digits pass s8 (the limb-row
    kernel's shapes, K7's base 2^8)."""
    import torch
    import torch.nn.functional as F

    def limbs(x, count):
        out = []
        for _ in range(count):
            e = ((x + 128) & 255) - 128
            x = (x - e) >> 8
            out.append(e.to(torch.int8))
        return out

    b, k = digits.shape
    m = words.shape[1]
    kpad, npad = (-k) % 8, (-m) % 8
    dl = [F.pad(e, (0, kpad)) for e in limbs(digits, (base_log + 8) // 8)]
    wl = [F.pad(e, (0, npad, 0, kpad)) for e in limbs(words, 8)]
    acc = torch.zeros((b, m), dtype=torch.int64, device=digits.device)
    for t, d8 in enumerate(dl):
        for j in range(8 - t):
            acc += torch._int_mm(d8, wl[j])[:, :m].to(torch.int64) << (8 * (t + j))
    return acc


def int_mm_limb_keyswitch(ct, ksk, base_log: int, levels: int):
    """K1 at the limb-row kernel's shapes as int8 GEMMs (int_mm_limb_product:
    21 at the PFPKS's base 2^20, 26 at the cast's 2^24).  A library
    yardstick for the limb-row kernel (the port never calls it)."""
    from tfhe_tpu_torch.ops import server

    b = ct.shape[0]
    n_in, lev, m_out = ksk.shape
    digits = server.signed_decompose(ct[:, :-1], base_log, levels)
    out = -int_mm_limb_product(digits.permute(1, 2, 0).reshape(b, -1),
                               ksk.reshape(-1, m_out), base_log)
    out[:, -1] += ct[:, -1]
    return out


def standard_glwe_key(key, dp):
    """The u64 words (k_in, l, k_out+1, N) of a Montgomery NTT-domain key
    (k_in, l, k_out+1, P, N): Montgomery form dropped, the inverse
    transform and Garner."""
    import torch
    from tfhe_tpu_torch.ops import ntt

    normal = ntt.redc(key.to(torch.int64), dp.ps, dp.pinvs)
    return ntt.garner_to_u64(ntt.ntt_inverse(normal, dp), dp)


def int_mm_glwe_keyswitch(glwe, words, base_log: int, levels: int, add_sum: bool):
    """K7's function as int8 GEMMs: the digits (B, k_in l N) times the
    key's negacyclic Toeplitz (k_in l N, (k_out+1) N) of its words (the
    route of row 0b's yardstick, int_mm_limb_product's limbs), wrapping mod
    2^64, then the sign and the body.  The integer sum stays below P/2 at
    the research shapes (|d| <= 2^(base_log-1), k_in l N terms: 2^84 and
    2^85 against P > 2^118), so these are the CRT route's words.  A
    library yardstick for K7 (the port never calls it)."""
    import torch
    from tfhe_tpu_torch.ops import server

    b, kin1, n = glwe.shape
    k_in, lev, kout1, _ = words.shape
    digits = server.signed_decompose(glwe[:, :-1], base_log, levels)   # (l, B, k_in, N)
    rows = digits.permute(1, 2, 0, 3).reshape(b, -1)                    # (B, (i, lev, s))
    s_idx = torch.arange(n, device=glwe.device)
    src = s_idx[None, :] - s_idx[:, None] + n                            # [s, t] = t - s + N
    kx = torch.cat([-words, words], dim=-1).reshape(k_in * lev, kout1, 2 * n)
    toeplitz = kx[:, :, src].permute(0, 2, 1, 3).reshape(k_in * lev * n, kout1 * n)
    total = int_mm_limb_product(rows, toeplitz, base_log).reshape(b, kout1, n)
    out = total if add_sum else -total
    out[:, -1] += glwe[:, -1]
    return out


def limb_entry(kernels, ct, key, base_log: int, levels: int):
    """K1's limb-row kernel through its C entry alone, its output and
    scratch allocated once and its split count asked once (a function to
    time: the wrapper's host work left out)."""
    import torch

    b, n_in = ct.shape[0], ct.shape[1] - 1
    m_out = key.words.shape[2]
    n_chunks, key_cols = key.limbs.shape[0], key.limbs.shape[1]
    rows = kernels.limb_rows(b, kernels.keyswitch_limb_count(n_in, levels, base_log))
    splits = kernels.keyswitch_limb_splits(key_cols // kernels.IM_BN * (rows // kernels.IM_BM),
                                           n_chunks, kernels.sm_count(ct.device))
    out = torch.empty((b, m_out), dtype=torch.int64, device=ct.device)
    digits = torch.empty((rows, n_chunks, key.limbs.shape[2]), dtype=torch.int8,
                         device=ct.device)
    fn = kernels.load()["keyswitch"].tfhe_torch_keyswitch_limbs
    args = (out.data_ptr(), ct.data_ptr(), key.limbs.data_ptr(), digits.data_ptr(), b, n_in,
            levels, m_out, base_log, n_chunks, key_cols, splits)

    def run():      # on the current stream (a graph's capture stream too)
        err = fn(*args, kernels._stream(ct))
        if err:
            raise RuntimeError(f"K1's limb-row kernel failed: cudaError {err}")
        return out

    return run, splits


# the times limb_route_figures takes of the limb-row kernel
# K2's CMux entry's figures in the kernel line (cmux_route_figures; its
# route goes in as "cmux_route": the line's "route" is the kernel's language)
CMUX_FIGURES = ("ms", "graph_ms_in_turns", "generic_ms", "generic_graph_ms_in_turns",
                "wrapper_ms", "wrapper_host_ms", "plain_ms", "share_of_bound",
                "shared_memory_bytes", "active_clusters", "shape")
LIMB_TIMES = ("ms", "generic_kernel_ms", "graph_in_turns_ms", "wrapper_ms", "entry_ms",
              "generic_kernel_events_ms", "in_turns_ms", "wrapper_host_ms", "entry_host_ms")


def limb_route_figures(kernels, server, ct, words, key, base_log: int, levels: int) -> dict:
    """K1's limb-row kernel at one of its shapes: the wrapper, its C entry
    alone and the generic kernel (the first design there) in turns
    (generic, wrapper, entry, entry, wrapper, generic; CUDA events over 20
    launches, with the host's enqueue ms a launch), then the C entry and
    the generic kernel in turns replayed from CUDA graphs (the device's
    time, the host's out of it: "ms"); the plain version, the int8
    torch._int_mm yardstick and its words, the bound, the split count."""
    entry, splits = limb_entry(kernels, ct, key, base_log, levels)
    want = server.keyswitch(ct, words, base_log, levels)
    generic = lambda: generic_keyswitch(kernels, ct, words, base_log, levels)  # noqa: E731
    runs = {"generic": generic,
            "wrapper": lambda: kernels.keyswitch(ct, key, base_log, levels), "entry": entry}
    errs = {name: max_abs_err(run(), want) for name, run in runs.items()}
    times = in_turns(runs, 20)
    graphs = {name: [] for name in ("generic", "entry")}
    for name in ("generic", "entry", "entry", "generic"):
        graphs[name].append(graph_ms(runs[name]))
    lib = int_mm_limb_keyswitch(ct, words, base_log, levels)
    bound = k1_bound(ct, words, want, base_log)
    return {"ms": min(graphs["entry"]), "generic_kernel_ms": min(graphs["generic"]),
            "graph_in_turns_ms": graphs,
            "wrapper_ms": min(t for t, _ in times["wrapper"]),
            "entry_ms": min(t for t, _ in times["entry"]),
            "generic_kernel_events_ms": min(t for t, _ in times["generic"]),
            "in_turns_ms": times,
            "wrapper_host_ms": min(h for _, h in times["wrapper"]),
            "entry_host_ms": min(h for _, h in times["entry"]),
            "words_differing": errs, "library_words_differing": max_abs_err(lib, want),
            "plain_ms": cuda_ms(lambda: server.keyswitch(ct, words, base_log, levels), 3),
            "library_ms": cuda_ms(lambda: int_mm_limb_keyswitch(ct, words, base_log, levels), 5),
            "library_call": f"{sum(8 - t for t in range((base_log + 8) // 8))} int8 "
                            f"torch._int_mm GEMMs of balanced byte limbs",
            "bound": bound, "splits": splits,
            "limbs_a_digit": kernels.keyswitch_limb_count(ct.shape[1] - 1, levels, base_log),
            "shape": [ct.shape[0], ct.shape[1] - 1, levels, words.shape[2]]}


def generic_packing_keyswitch(kernels, lwes, pksk, base_log: int, levels: int,
                              per_glwe: int):
    """K4's generic kernel (csrc/packing_keyswitch.cu packing_keyswitch_kernel)
    through its C entry, at any shape it takes: at the V1_4 compression
    shape, the kernel the tensor-core kernel replaced."""
    import torch

    b = lwes.shape[0]
    n_in, _, k1, n_poly = pksk.shape
    out = torch.zeros((-(-b // per_glwe), k1, n_poly), dtype=torch.int64, device=lwes.device)
    err = kernels.load()["packing_keyswitch"].tfhe_torch_packing_keyswitch(
        out.data_ptr(), lwes.data_ptr(), pksk.data_ptr(), b, n_in, levels, k1,
        n_poly.bit_length() - 1, per_glwe, base_log, kernels._stream(lwes))
    if err:
        raise RuntimeError(f"K4's generic kernel failed: cudaError {err}")
    return out


def int_mm_operands(lwes, pksk, base_log: int, levels: int, per_glwe: int):
    """The packing keyswitch as int8 GEMMs: for each GLWE the s8 Toeplitz
    matrix of its digits, A[t, (i, lev, m)] = Dx[t - m] (Dx the digit vector
    extended negacyclically), (N, n l N); the key's 10 seven-bit limbs,
    B[(i, lev, m), (c, e)], (n l N, 10 (k+1)) padded to 8 columns; and the
    K chunk whose s32 sums stay exact (chunk 2^(base_log-1) 127 < 2^31)."""
    import torch
    from tfhe_tpu_torch.ops import server

    n_in, _, k1, n_poly = pksk.shape
    digits = server.signed_decompose(lwes[:, :-1], base_log, levels).to(torch.int8)
    key = torch.stack([(pksk >> (7 * e)) & 127 for e in range(10)], dim=-1)
    key = key.permute(0, 1, 3, 2, 4).reshape(n_in * levels * n_poly, 10 * k1).to(torch.int8)
    key = torch.nn.functional.pad(key, (0, -key.shape[1] % 8)).contiguous()
    coeff = torch.arange(n_poly, device=lwes.device)
    idx = coeff[:, None] - coeff[None, :] + n_poly
    mats = []
    for start in range(0, lwes.shape[0], per_glwe):
        d = digits[:, start:start + per_glwe]
        dx = torch.zeros((n_in, levels, n_poly), dtype=torch.int8, device=lwes.device)
        dx[:, :, :d.shape[1]] = d.permute(2, 0, 1)
        ext = torch.cat([-dx, dx], dim=-1)          # ext[s] = Dx[s - N]
        mats.append(ext[:, :, idx].permute(2, 0, 1, 3).reshape(n_poly, -1).contiguous())
    chunk = ((1 << 31) - 1) // ((1 << (base_log - 1)) * 127) // n_poly * n_poly
    return mats, key, chunk


def int_mm_gemms(mats, key, chunk: int) -> list:
    """Each GLWE's int8 GEMMs (torch._int_mm) in K chunks, summed in int64:
    (N, 10 (k+1) padded) limb sums."""
    import torch

    out = []
    for a in mats:
        acc = None
        for k0 in range(0, a.shape[1], chunk):
            part = torch._int_mm(a[:, k0:k0 + chunk].contiguous(),
                                 key[k0:k0 + chunk]).to(torch.int64)
            acc = part if acc is None else acc + part
        out.append(acc)
    return out


def int_mm_packing_keyswitch(lwes, pksk, base_log: int, levels: int, per_glwe: int):
    """The packing keyswitch through int8 torch._int_mm GEMMs of the digits'
    Toeplitz matrices by seven-bit limbs of the key (int_mm_operands),
    recombined mod 2^64, negated, bodies added.  A library yardstick for K4."""
    import torch

    k1 = pksk.shape[2]
    sums = int_mm_gemms(*int_mm_operands(lwes, pksk, base_log, levels, per_glwe))
    out = []
    for g, acc in enumerate(sums):
        limbs = acc[:, :10 * k1].reshape(-1, k1, 10)
        words = sum(limbs[..., e] << (7 * e) for e in range(10))
        glwe = -words.T
        bodies = lwes[g * per_glwe:(g + 1) * per_glwe, -1]
        glwe[-1, :bodies.shape[0]] += bodies
        out.append(glwe)
    return torch.stack(out)


def extreme_mask_word(server, base_log: int, levels: int) -> int:
    """The mask word (int64) whose signed digits sum to the most negative
    value the balanced decomposition reaches, its lowest digit at
    -2^(base_log-1) (-8, -7, -7 at 2^4, 3 levels: two -8 in a row do not
    occur): the largest limb sums of K4's tensor-core kernel on a real
    mask."""
    import torch

    rep = base_log * levels
    tops = torch.arange(1 << rep, dtype=torch.int64) << (64 - rep)
    digits = server.signed_decompose(tops, base_log, levels)
    sums = digits.sum(dim=0)
    pick = (sums == sums.min()) & (digits[0] == -(1 << (base_log - 1)))
    return int(tops[pick][0])


def generic_exact_rotation(kernels, server, mask, body, lut, key, dp, base_log: int,
                           levels: int):
    """K2's generic exact kernel (csrc/blind_rotate.cu blind_rotate_kernel)
    through its C entry, at any shape it takes: at the V1_4 2_2 shape, the
    kernel the lazy exact kernel replaced."""
    return generic_exact_rotate(kernels, server.initial_accumulator(lut, body, False), mask,
                                key, dp, base_log, levels)


def generic_exact_rotate(kernels, acc, mask, key, dp, base_log: int, levels: int):
    """generic_exact_rotation of a given accumulator (a new tensor): at the
    CM shapes k+1 = 3 and 4, the kernel the cluster kernel replaced."""
    import torch

    acc = acc.clone(memory_format=torch.contiguous_format)
    mask32 = mask.to(torch.int32).contiguous()
    k1, n_poly = acc.shape[1], acc.shape[2]
    err = kernels.load()["blind_rotate"].tfhe_torch_blind_rotate(
        acc.data_ptr(), mask32.data_ptr(), key.data_ptr(), dp.psi32.data_ptr(),
        dp.psi_inv32.data_ptr(), dp.kernel_consts.data_ptr(), acc.shape[0], mask32.shape[1],
        k1, n_poly.bit_length() - 1, levels, dp.num_primes, base_log, kernels._stream(acc))
    if err:
        raise RuntimeError(f"K2's generic exact kernel failed: cudaError {err}")
    return acc


def extended_lazy_slots(kernels, acc, mask, key, dp, base_log: int, levels: int, sb: int):
    """K8's lazy kernel through its C entry at SB slots a block (one of
    kernels.K8_SLOTS), whichever kernels.extended_slots would pick; returns
    the final accumulator (a new tensor)."""
    import torch

    from tfhe_tpu_torch.ops import ntt

    acc = acc.clone(memory_format=torch.contiguous_format)
    mask32 = mask.to(torch.int32).contiguous()
    tw_fwd, tw_inv = ntt.shoup_twiddles(dp)
    b, e, k1, n_poly = acc.shape
    err = kernels.load()["blind_rotate_extended"].tfhe_torch_blind_rotate_extended_lazy(
        acc.data_ptr(), mask32.data_ptr(), key.data_ptr(), tw_fwd.data_ptr(), tw_inv.data_ptr(),
        dp.kernel_consts.data_ptr(), b, mask32.shape[1], k1, n_poly.bit_length() - 1, levels,
        base_log, e.bit_length() - 1, sb, kernels._stream(acc))
    if err:
        raise RuntimeError(f"K8's lazy kernel at {sb} slots a block failed: cudaError {err}")
    return acc


def k1_bound(ct, ksk, out, base_log: int = 8, word_bytes: int = 8) -> dict:
    """Least time for the keyswitch: every input byte read once and the
    output written once (the key's and the output's words word_bytes wide: 8
    for K1, 4 for K1-32's u32 words), against the cheaper way to do its
    wrapping multiply-adds: as ceil(base_log / 8) digit bytes x word_bytes
    key bytes of int8 limb products on the tensor cores, or on the CUDA
    cores' 32-bit integer rate, three multiplies for a u64 product and one
    for a u32 product (the int8 way wins at every base_log <= 8)."""
    nbytes = 8 * ct.numel() + word_bytes * (ksk.numel() + out.numel())
    n_in, levels, m_out = ksk.shape
    macs = ct.shape[0] * n_in * levels * m_out
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = min(2 * word_bytes * -(-base_log // 8) * macs / INT8_TC_OPS_PER_S,
                (3 if word_bytes == 8 else 1) * macs / INT32_MUL_PER_S)
    return {"ms": max(t_bytes, t_ops) * 1e3, "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3}


def k2_bound(mask, lut, levels: int, base_log: int, nprimes: int,
             word_bytes: int = 8) -> dict:
    """Least time for the blind rotation with nprimes CRT primes: the key
    (NTT domain, u32 residues), mask, body, LUT and output (word_bytes a
    coefficient: 8 on the u64 torus, 16 on the u128 torus) moved once,
    against the cheaper of two ways to do its products.

    ntt: radix-2 NTTs, pointwise products and Garner, each a Montgomery
    product of 32-bit residues (three 32-bit multiplies) on the CUDA cores'
    integer rate; N^-1 is taken as folded into the key, so no pass of its own.
    four_step: tfhe_tpu's MXU formulation (tfhe_tpu/ops/mxu.py:1-18), dense
    N1 x N1 stage-1 DFTs and the key's collapsed N2 x N2 middle maps as
    byte-limb int8 products on the tensor cores, ceil(base_log / 8) bytes a
    digit and 4 bytes a residue."""
    b, n_steps = mask.shape
    k1, n_poly = lut.shape[1], lut.shape[2]
    log_n = n_poly.bit_length() - 1
    butterflies = (n_poly // 2) * log_n
    modmuls = (levels * k1 * nprimes * butterflies           # forward NTTs
               + levels * k1 * k1 * nprimes * n_poly          # pointwise MACs
               + k1 * nprimes * butterflies                   # inverse NTTs
               + k1 * n_poly * nprimes * (nprimes - 1) // 2)  # Garner
    t_ntt = b * n_steps * 3 * modmuls / INT32_MUL_PER_S
    n1 = FOUR_STEP_N1
    n2 = n_poly // n1
    digit_bytes = -(-base_log // 8)
    limb_macs = nprimes * (levels * k1 * n2 * n1 * n1 * 4 * digit_bytes  # stage 1
                           + n1 * levels * k1 * n2 * k1 * n2 * 16        # middle
                           + k1 * n2 * n1 * n1 * 16)                     # inverse
    t_four_step = b * n_steps * 2 * limb_macs / INT8_TC_OPS_PER_S
    key_bytes = 4 * n_steps * levels * k1 * k1 * nprimes * n_poly
    t_bytes = (key_bytes + 4 * mask.numel() + 8 * b
               + 2 * word_bytes * lut.numel()) / HBM_BYTES_PER_S
    t_ops = min(t_ntt, t_four_step)
    return {"ms": max(t_bytes, t_ops) * 1e3,
            "by": "bytes" if t_bytes >= t_ops else "operations",
            "ntt_ms": t_ntt * 1e3, "four_step_ms": t_four_step * 1e3,
            "bytes_ms": t_bytes * 1e3}


def k5_bound(mask, lut_lo, levels: int, base_log: int) -> dict:
    """Least time for the u128 blind rotation, counted as k2_bound counts
    K2's: the six primes the exact product needs, l (k+1) digit
    polynomials a step, u128 LUT and output words."""
    return k2_bound(mask, lut_lo, levels, base_log, K5_PRIMES, word_bytes=16)


def k3_bound(degrees, lut, levels: int, base_log: int, nprimes: int,
             v9: bool) -> dict:
    """Least time for the multi-bit blind rotation with nprimes CRT primes,
    as k2_bound counts it.  v9 (monomials on the data side): per group and
    ciphertext, 2^g decompositions transformed and multiplied with their
    pattern keys, one inverse transform and Garner.  Exact (the key bundle):
    one forward transform set, the bundle's (2^g - 1) l (k+1)^2 P N products,
    the product with it, one inverse and Garner."""
    b, n_groups, n_sub = degrees.shape
    k1, n_poly = lut.shape[1], lut.shape[2]
    log_n = n_poly.bit_length() - 1
    butterflies = (n_poly // 2) * log_n
    pointwise = levels * k1 * k1 * nprimes * n_poly
    fwd = levels * k1 * nprimes * butterflies
    tail = (k1 * nprimes * butterflies                     # inverse NTTs
            + k1 * n_poly * nprimes * (nprimes - 1) // 2)  # Garner
    if v9:
        modmuls = n_sub * (fwd + pointwise) + tail
    else:
        modmuls = fwd + (n_sub - 1) * pointwise + pointwise + tail
    t_ntt = b * n_groups * 3 * modmuls / INT32_MUL_PER_S
    n1 = FOUR_STEP_N1
    n2 = n_poly // n1
    digit_bytes = -(-base_log // 8)
    stage1 = levels * k1 * n2 * n1 * n1 * 4 * digit_bytes
    middle = n1 * levels * k1 * n2 * k1 * n2 * 16
    inverse = k1 * n2 * n1 * n1 * 16
    copies = n_sub if v9 else 1
    limb_macs = nprimes * (copies * (stage1 + middle) + inverse)
    t_four_step = b * n_groups * 2 * limb_macs / INT8_TC_OPS_PER_S
    if not v9:      # the bundle itself stays on the CUDA cores
        t_four_step += b * n_groups * 3 * (n_sub - 1) * pointwise / INT32_MUL_PER_S
    key_bytes = 4 * n_groups * n_sub * levels * k1 * k1 * nprimes * n_poly
    t_bytes = (key_bytes + 4 * degrees.numel() + 8 * b
               + 2 * 8 * lut.numel()) / HBM_BYTES_PER_S
    t_ops = min(t_ntt, t_four_step)
    return {"ms": max(t_bytes, t_ops) * 1e3,
            "by": "bytes" if t_bytes >= t_ops else "operations",
            "ntt_ms": t_ntt * 1e3, "four_step_ms": t_four_step * 1e3,
            "bytes_ms": t_bytes * 1e3}


def k4_bound(lwes, pksk, out, per_glwe: int, nprimes: int) -> dict:
    """Least time for the packing keyswitch: every input byte read once and
    the output written once, against the cheaper of two ways to do its
    products.  limbs: the direct product, sum_g b_g n l (k+1) N
    multiply-adds of a digit by 8 byte limbs of a key word on the int8
    tensor cores (as k1_bound counts K1).  ntt: nprimes-prime CRT-NTTs on
    the CUDA cores' integer rate (three 32-bit multiplies a Montgomery
    product): the key's transforms once, and per GLWE the digits'
    transforms, the pointwise products, the inverse transforms and Garner.
    nprimes: what the exact product needs (|X| < 8 2^64 N n l)."""
    b = lwes.shape[0]
    n_in, levels, k1, n_poly = pksk.shape
    n_glwe = out.shape[0]
    filled = sum(min(per_glwe, b - g * per_glwe) for g in range(n_glwe))
    macs = filled * n_in * levels * k1 * n_poly
    t_limbs = 2 * 8 * macs / INT8_TC_OPS_PER_S
    butterflies = (n_poly // 2) * (n_poly.bit_length() - 1)
    modmuls = (n_in * levels * k1 * nprimes * butterflies
               + n_glwe * (n_in * levels * nprimes * butterflies
                           + n_in * levels * k1 * nprimes * n_poly
                           + k1 * nprimes * butterflies
                           + k1 * n_poly * nprimes * (nprimes - 1) // 2))
    t_ntt = 3 * modmuls / INT32_MUL_PER_S
    t_bytes = 8 * (lwes.numel() + pksk.numel() + out.numel()) / HBM_BYTES_PER_S
    t_ops = min(t_limbs, t_ntt)
    return {"ms": max(t_bytes, t_ops) * 1e3,
            "by": "bytes" if t_bytes >= t_ops else "operations",
            "limbs_int8_ms": t_limbs * 1e3, "ntt_int32_ms": t_ntt * 1e3,
            "bytes_ms": t_bytes * 1e3}


def random_ntt_key(shape, dp, gen):
    """A random NTT-domain key: residues below each prime, int32."""
    import torch

    return torch.stack(
        [torch.randint(0, q, shape + (dp.n,), generator=gen, device=gen.device)
         for q in dp.plan.primes], dim=-2).to(torch.int32)


def key_bytes(key) -> int:
    """Device bytes of an NTT-domain key: an exact int32 tensor or a
    RoundedKeyNtt."""
    return key.nbytes if hasattr(key, "round_bits") else key.numel() * 4


def four_prime_rounded_key(coeff, round_bits: int, dp):
    """The exact-layout four-prime NTT key of round_bsk(coeff, rb), built on
    the card: the key K2 and K3 ran v7 and v9 mode on before the
    rounded-key routes (the NTT of the rounded u64 words, not of their
    quotients).  The rounded-key routes must give its words."""
    import numpy as np
    import torch
    from tfhe_tpu_torch.ops import ntt

    data = np.asarray(getattr(coeff, "data", coeff))
    flat = data.reshape(-1, data.shape[-1])
    out = torch.empty((flat.shape[0], dp.num_primes, dp.n), dtype=torch.int32,
                      device=dp.psi.device)
    half, mask = 1 << (round_bits - 1), (1 << round_bits) - 1
    step = 1 << 11
    for s in range(0, flat.shape[0], step):
        w = torch.from_numpy(np.ascontiguousarray(flat[s:s + step]).view(np.int64)).to(out.device)
        w = (w + half) & ~mask
        res = torch.stack([(torch.remainder(w, q) + torch.where(w < 0, (1 << 64) % q, 0)) % q
                           for q in dp.plan.primes], dim=-2)
        out[s:s + step] = ntt.mont_mul(ntt.ntt_forward(res, dp), dp.r2s, dp.ps,
                                       dp.pinvs).to(torch.int32)
    return out.reshape(data.shape[:-1] + (dp.num_primes, dp.n))


def head_of(key, lead: tuple):
    """The first GGSWs of a RoundedKeyNtt, as a key of that many steps
    (groups)."""
    import dataclasses
    import math

    return dataclasses.replace(key, data=key.data[:math.prod(lead)], lead=lead)


def ptxas_start(kernels) -> tuple:
    """Start ``nvcc -Xptxas -v`` on every kernel source, one compiler per
    source, all together, into a scratch directory (the libraries are
    thrown away).  Returns the directory and the (name, process) pairs for
    ptxas_report."""
    import tempfile
    from tfhe_tpu_torch.utils.build import CSRC

    tmp = tempfile.mkdtemp(dir=CSRC.parents[1] / "build")
    return tmp, [(name, subprocess.Popen(
        kernels.nvcc_command() + ["-Xptxas", "-v", "-o", f"{tmp}/{name}.so",
                                  str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name in ("keyswitch", "blind_rotate", "blind_rotate_cluster",
                     "blind_rotate_multibit", "blind_rotate_multibit_cluster",
                     "packing_keyswitch", "blind_rotate128",
                     "packing_keyswitch128", "glwe_keyswitch", "blind_rotate_extended",
                     "poly_shard")]


def ptxas_stop(started: tuple) -> None:
    """Stop ptxas_start's compilers (those still running) and remove their
    directory; a second call does nothing."""
    import shutil

    tmp, procs = started
    for _, proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    shutil.rmtree(tmp, ignore_errors=True)


def ptxas_report(kernels, started: tuple) -> dict:
    """Registers, spills and static shared memory of every kernel as
    ptxas_start's compilers report them (each waited for), and the
    rounded-key kernels' dynamic shared memory and ciphertexts a block."""
    import re

    out = {}
    _, procs = started
    try:
        for name, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc -Xptxas -v of {name}.cu failed:\n{log}")
            fn = None
            for line in log.splitlines():
                m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
                if m:
                    fn = m.group(1)
                    continue
                if fn is None or "_kernel" not in fn:
                    continue
                entry = out.setdefault(fn, {})
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    entry["spill_store_bytes"], entry["spill_load_bytes"] = map(int, m.groups())
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    entry["registers"] = int(m.group(1))
                    m = re.search(r"(\d+) bytes smem", line)
                    entry["static_smem_bytes"] = int(m.group(1)) if m else 0
    finally:
        ptxas_stop(started)
    for nprimes in (3, 4):
        out[f"rounded_{nprimes}_primes"] = kernels.rounded_kernel_shape(nprimes)
    return out


def cluster_regs(report: dict, k1: int, levels: int, log_n: int, cmux: bool = False) -> dict:
    """ptxas's registers and spills of K2's cluster kernel's instance at a
    shape (its template arguments in the mangled name), the rotation's or
    (cmux) the CMux mode's."""
    regs = next((v for k, v in report.items()
                 if f"blind_rotate_cluster_kernelILi{k1}ELi{levels}ELi{log_n}ELb{int(cmux)}E"
                 in k), {})
    return {"registers": regs.get("registers"), "spill_store_bytes": regs.get(
        "spill_store_bytes")}


def small_regs(report: dict, levels: int, k1: int = 2, cmux: bool = False) -> dict:
    """ptxas's registers and spills of K2's small-N cluster kernel at k+1 =
    k1, l = levels, the rotation's instance or (cmux) the CMux mode's."""
    regs = next((v for k, v in report.items()
                 if f"blind_rotate_cluster_small_kernelILi{k1}ELi{levels}ELb{int(cmux)}E" in k),
                {})
    return {"registers": regs.get("registers"), "spill_store_bytes": regs.get(
        "spill_store_bytes")}


def multibit_cluster_regs(report: dict, n_poly: int, levels: int, grouping: int) -> dict:
    """ptxas's registers and spills of K3's cluster kernel's instance at a
    shape (its template arguments log N, l, 2^g in the mangled name)."""
    name = (f"blind_rotate_multibit_cluster_kernelILi{n_poly.bit_length() - 1}ELi{levels}"
            f"ELi{1 << grouping}E")
    regs = next((v for k, v in report.items() if name in k), {})
    return {"registers": regs.get("registers"), "spill_store_bytes": regs.get(
        "spill_store_bytes")}


def ptxas_of(report: dict, name: str) -> dict:
    """ptxas's figures for one kernel of ptxas_report, found by its name in
    the mangled entry name (the length prefix keeps keyswitch_kernel from
    matching packing_keyswitch_kernel)."""
    return next((v for k, v in report.items() if k == name or f"{len(name)}{name}" in k), {})


def kernel_ms_by_name(prof, names) -> dict:
    """Mean device milliseconds per launch of each named kernel in a
    torch.profiler trace (None where the trace shows no device time)."""
    out = {n: None for n in names}
    for evt in prof.key_averages():
        for n in names:
            if n in evt.key and evt.count:
                total = getattr(evt, "device_time_total",
                                getattr(evt, "cuda_time_total", 0))
                if total:
                    out[n] = total / evt.count / 1e3
    return out


def kernel_wrappers(kernels) -> tuple:
    return (kernels.keyswitch, kernels.keyswitch32, kernels.blind_rotate, kernels.cmux_step,
            kernels.cmux_chain, kernels.cmux, kernels.blind_rotate_multibit,
            kernels.packing_keyswitch,
            kernels.blind_rotate128, kernels.packing_keyswitch128, kernels.glwe_keyswitch,
            kernels.blind_rotate_extended, kernels.poly_shard_forward, kernels.poly_shard_cross,
            kernels.poly_shard_inverse, kernels.poly_shard_rotate)


def counters(kernels) -> tuple:
    """(name, wrapper, attribute) of every launch count: each wrapper's
    launches and, of them, those of K1's and K4's tensor-core kernels, of
    K1's limb-row kernel, of K2's lazy exact kernel (the rotation's and the
    step entry's), of its cluster kernel, of its CMux entry's small and
    cluster routes, of K3's cluster kernel, of K7's cluster kernel and of
    K8's lazy kernel."""
    return tuple((w.__name__, w, "launches") for w in kernel_wrappers(kernels)) + (
        ("keyswitch_imma", kernels.keyswitch, "imma_launches"),
        ("keyswitch_limbs", kernels.keyswitch, "limb_launches"),
        ("keyswitch32_imma", kernels.keyswitch32, "imma_launches"),
        ("packing_keyswitch_imma", kernels.packing_keyswitch, "imma_launches"),
        ("blind_rotate_exact_lazy", kernels.blind_rotate, "lazy_exact_launches"),
        ("blind_rotate_cluster", kernels.blind_rotate, "cluster_launches"),
        ("blind_rotate_multibit_cluster", kernels.blind_rotate_multibit, "cluster_launches"),
        ("cmux_step_exact_lazy", kernels.cmux_step, "lazy_exact_launches"),
        ("cmux_small", kernels.cmux, "small_launches"),
        ("cmux_cluster", kernels.cmux, "cluster_launches"),
        ("blind_rotate_extended_lazy", kernels.blind_rotate_extended, "lazy_launches"),
        ("glwe_keyswitch_cluster", kernels.glwe_keyswitch, "cluster_launches"))


def reset_counts(kernels) -> None:
    for _, w, attr in counters(kernels):
        setattr(w, attr, 0)


def read_counts(kernels) -> dict:
    return {name: getattr(w, attr) for name, w, attr in counters(kernels)}


def only(kernels, **counts) -> dict:
    """The launch counts of a run that launched the named kernels the given
    times and no other kernel."""
    return {name: counts.get(name, 0) for name, _, _ in counters(kernels)}


def generic_keyswitches(launches: dict) -> int:
    """K1 launches of a run's counts on its generic kernel: neither the
    tensor-core nor the limb-row kernel."""
    return launches["keyswitch"] - launches["keyswitch_imma"] - launches["keyswitch_limbs"]


def counted(kernels, fn):
    """Run fn with every kernel's launch count set to 0 just before; return
    (fn's result, the counts just after, seconds, host seconds: until fn
    returned, before the wait for the card)."""
    import torch

    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    host_seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, read_counts(kernels), seconds, host_seconds


def serve_rounds(ck, sk, seed: int, kernels) -> dict:
    """ROUNDS batched rounds at B = BATCH with LUT (3x+1) % 16, then one
    chained round on the device-resident outputs (plus 5, message
    extracted) under the profiler, after one warm-up run of it: ROUNDS + 2
    rounds.  Every kernel's launch count is set to 0 just before and read
    just after; every output of the ROUNDS + 1 kept rounds is decrypted.
    A round's host seconds end when its call returns, before the wait for
    the card: they tell a host stall from a slow kernel."""
    import numpy as np
    import torch

    p = sk.params
    rng = np.random.default_rng(seed)
    msg = p.message_modulus
    inputs = [rng.integers(0, msg, BATCH) for _ in range(ROUNDS)]
    cts = [[ck.encrypt(int(v)) for v in vals] for vals in inputs]
    lut = sk.generate_lookup_table(lambda x: (3 * x + 1) % 16)
    lut_msg = sk.generate_msg_lookup_table(lambda x: x)
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    round_s, host_s, outs = [], [], []
    for r in range(ROUNDS):
        t1 = time.perf_counter()
        outs.append(sk.apply_lookup_table_batch(cts[r], lut))
        host_s.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t1)
    serve_s = time.perf_counter() - t0
    # the chained round runs under the profiler, which splits it into kernel
    # times (the timed rounds above run without it).  One warm-up step of the
    # same round comes first: a trace's first step can miss kernels.  The
    # recorded step's kernel times are read when the profiler hands it over.
    shifted = [sk.unchecked_scalar_add(ct, 5) for ct in outs[-1]]
    names = ("keyswitch_kernel", "keyswitch_imma_kernel", "blind_rotate_kernel",
             "blind_rotate_multibit_kernel", "blind_rotate_rounded_kernel",
             "blind_rotate_multibit_rounded_kernel")
    per_launch = dict.fromkeys(names)
    trace = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
        on_trace_ready=lambda prof: per_launch.update(kernel_ms_by_name(prof, names)))
    with trace:
        sk.apply_lookup_table_batch(shifted, lut_msg)
        torch.cuda.synchronize()
        trace.step()
        t1 = time.perf_counter()
        chained = sk.apply_lookup_table_batch(shifted, lut_msg)
        torch.cuda.synchronize()
        chained_s = time.perf_counter() - t1
        trace.step()
    launches = read_counts(kernels)
    wrong = 0
    for r in range(ROUNDS):
        for ct, v in zip(outs[r], inputs[r]):
            wrong += ck.decrypt_raw(ct) != (3 * int(v) + 1) % 16
    chained_want = [((3 * int(v) + 1) % 16 + 5) % msg for v in inputs[-1]]
    for ct, want in zip(chained, chained_want):
        wrong += ck.decrypt(ct) != want
    return {"cts": cts, "inputs": inputs, "lut": lut, "launches": launches,
            "chained": chained, "chained_want": chained_want, "line": {
        "batch": BATCH, "rounds": ROUNDS, "round_seconds": round_s,
        "round_host_seconds": host_s,
        "pbs_per_s": ROUNDS * BATCH / serve_s,
        "pbs_per_s_after_first": (ROUNDS - 1) * BATCH / sum(round_s[1:]),
        "chained_round_seconds_traced": chained_s,
        "k1_ms_traced_round": (per_launch["keyswitch_imma_kernel"]
                               or per_launch["keyswitch_kernel"]),
        "k2_ms_traced_round": (per_launch["blind_rotate_rounded_kernel"]
                               or per_launch["blind_rotate_kernel"]),
        "k3_ms_traced_round": (per_launch["blind_rotate_multibit_rounded_kernel"]
                               or per_launch["blind_rotate_multibit_kernel"]),
        "launches": launches, "outputs_checked": (ROUNDS + 1) * BATCH,
        "wrong": wrong}}


def keyswitch_check(cts, sk, kernels, server, torus) -> dict:
    """K1 on a round's own input batch against its plain version and the
    int8-limb yardstick; times and bound.  Returns the K1 figures, the
    input batch and the plain keyswitch output (the blind rotations'
    inputs)."""
    import numpy as np
    import torch

    p = sk.params
    if not isinstance(sk.ks_key, kernels.KeyswitchKeyLimbs):
        raise RuntimeError("the server key holds no byte layout of its keyswitch key "
                           "for K1's tensor-core kernel")
    ct0 = torus.from_u64(np.stack([np.asarray(c.data) for c in cts]), sk.device)
    args = (ct0, sk.ksk, p.ks_base_log, p.ks_level)
    kargs = (ct0, sk.ks_key, p.ks_base_log, p.ks_level)
    got = kernels.keyswitch(*kargs)
    want = server.keyswitch(*args)
    lib = int_mm_keyswitch(*args)
    torch.cuda.synchronize()
    bound = k1_bound(ct0, sk.ksk, got, p.ks_base_log)
    return {"want": want, "ct": ct0, "fig": {
        "max_abs_err": max_abs_err(got, want),
        "int_mm_max_abs_err": max_abs_err(lib, want),
        "generic_kernel_max_abs_err": max_abs_err(generic_keyswitch(kernels, *args), want),
        "ms": cuda_ms(lambda: kernels.keyswitch(*kargs), 10),
        "generic_kernel_ms": cuda_ms(lambda: generic_keyswitch(kernels, *args), 10),
        "plain_ms": cuda_ms(lambda: server.keyswitch(*args), 3),
        "library_ms": cuda_ms(lambda: int_mm_keyswitch(*args), 10),
        "bound_ms": bound["ms"], "bound_by": bound["by"],
        "shape": [ct0.shape[0], p.big_lwe_dimension, p.ks_level, p.lwe_dimension + 1]}}


def switched_inputs(ks, p, server):
    """Modulus-switched mask and centered-mean body of a keyswitch output."""
    log_mod = p.polynomial_size.bit_length()
    body = ks[:, -1] + server.centered_binary_ms_correction(ks, log_mod)
    return ks[:, :-1], server.modulus_switch(body, log_mod), log_mod


def integer_keys(ti, ck, sk) -> tuple:
    """A shortint client and server key as integer keys, with no second
    keygen (as tfhe_tpu/hlapi/keys.py:63-70 wraps a shortint server key)."""
    ick = ti.ClientKey.__new__(ti.ClientKey)
    ick.key, ick.params = ck, ck.params
    return ick, ti.ServerKey.from_shortint_key(sk)


def integer_ops(isk, ick, a, b, x: int, y: int, scalar: int, cond, blocks: int,
                only=None) -> list:
    """(name, call, check) of the FheUint ops the integer phases run on a and
    b (encrypting x and y; cond encrypts True); check counts wrong outputs."""
    mod = isk.msg ** blocks
    x, y = x % mod, y % mod
    dec, dec_bool = ick.decrypt_radix, ick.decrypt_bool
    ops = [
        ("add", lambda: isk.add_parallelized(a, b), lambda o: dec(o) != (x + y) % mod),
        ("sub", lambda: isk.sub_parallelized(a, b), lambda o: dec(o) != (x - y) % mod),
        ("mul", lambda: isk.mul_parallelized(a, b), lambda o: dec(o) != (x * y) % mod),
        ("eq", lambda: isk.eq_parallelized(a, b), lambda o: dec_bool(o) != (x == y)),
        ("gt", lambda: isk.gt_parallelized(a, b), lambda o: dec_bool(o) != (x > y)),
        ("bitand", lambda: isk.bitand_parallelized(a, b), lambda o: dec(o) != x & y),
        ("scalar_mul", lambda: isk.scalar_mul_parallelized(a, scalar),
         lambda o: dec(o) != (x * scalar) % mod),
        ("if_then_else", lambda: isk.if_then_else_parallelized(cond, a, b),
         lambda o: dec(o) != x)]
    return [op for op in ops if only is None or op[0] in only]


class RoundLog:
    """Every round a shortint ServerKey runs, by wrapping its two batch
    entry points on the instance: each round's batch size, and the inputs,
    tables and outputs of the first round of ``keep`` ciphertexts (of the
    first round, where keep is "first")."""

    def __init__(self, sk, keep=None):
        self.sk, self.keep, self.sizes, self.kept = sk, keep, [], None
        apply_batch = sk.apply_lookup_table_batch
        decompress_batch = sk.decompress_and_apply_lookup_table_batch

        def apply(cts, luts):
            out = apply_batch(cts, luts)
            self.sizes.append(len(cts))
            if self.kept is None and self.keep in (len(cts), "first"):
                self.kept = (list(cts), luts, out)
            return out

        def decompress(compressed, luts):
            self.sizes.append(len(compressed))
            return decompress_batch(compressed, luts)

        sk.apply_lookup_table_batch = apply
        sk.decompress_and_apply_lookup_table_batch = decompress

    def close(self) -> None:
        del self.sk.apply_lookup_table_batch
        del self.sk.decompress_and_apply_lookup_table_batch


def measured_op(kernels, log, fn, check, warm: bool = True) -> tuple:
    """One integer (or gate) op: a warm-up call first (unless warm is
    False), then one call timed with the card synchronised before and after.
    Returns (its output, its line: seconds, rounds and the batch size of
    each, PBS, the launches it made, host materialisations (batches
    downloaded from the card), outputs decrypted wrong by check)."""
    from tfhe_tpu_torch.shortint.ciphertext import DeviceLweBatch

    if warm:
        fn()
    if log is not None:
        log.sizes.clear()
        pbs0 = log.sk.pbs_count
    downloads = DeviceLweBatch.downloads
    out, launches, seconds, host_seconds = counted(kernels, fn)
    line = {"seconds": seconds, "host_seconds": host_seconds,
            "host_materialisations": DeviceLweBatch.downloads - downloads,
            "launches": {k: v for k, v in launches.items() if v}}
    if log is not None:
        line.update({"rounds": len(log.sizes), "batch_sizes": list(log.sizes),
                     "pbs": log.sk.pbs_count - pbs0})
    line["wrong"] = int(check(out))
    return out, line


def op_kernel_seconds(fn, names) -> dict:
    """fn under the profiler, a warm-up step then a recorded one (a trace's
    first step can miss kernels): the recorded step's seconds, and the
    device seconds of the named kernels summed over its launches (None
    where the trace shows no device time)."""
    import torch

    total = []

    def ready(prof):
        total.append(sum(getattr(evt, "device_time_total", getattr(evt, "cuda_time_total", 0))
                         for evt in prof.key_averages()
                         if any(n in evt.key for n in names)))

    trace = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1), on_trace_ready=ready)
    with trace:
        fn()
        torch.cuda.synchronize()
        trace.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        trace.step()
    return {"profiled_seconds": seconds,
            "kernel_seconds": total[0] / 1e6 if total and total[0] else None}


def check_launches(tag: str, line: dict, must: dict, never=()) -> None:
    """Raise unless the op launched each kernel of ``must`` (name: the
    launches of another counter that it must equal, or None for at least
    once) and none of ``never``."""
    got = line["launches"]
    for name, equal_to in must.items():
        if not got.get(name) or (equal_to is not None and got.get(name) != got.get(equal_to)):
            raise RuntimeError(f"{tag} did not run {name} as it must: {got}")
    for name in never:
        if got.get(name):
            raise RuntimeError(f"{tag} ran {name}: {got}")


def integer_phase(kernels, ti, ick, isk, seed: int) -> dict:
    """Phase 14: the integer layer on a classic key (K1, then K2 v7, every
    round): the FheUint64 ops of integer_ops, each timed after a warm-up op
    (add and mul also profiled: their kernels' device seconds); FheUint8
    add, mul and a cast (to signed, then two trivial zero blocks on top);
    the scheduler's add_many and eq_many on BATCHED_PAIRS FheUint64 pairs
    (rounds of up to BATCHED_PAIRS x 32 = 512).  The cast takes a FheUint8 to
    a 12-bit signed integer of the same value (FheUint8 -> FheInt16's
    zero extension at 2 bits a block).  Every output decrypted
    against Python integers.  Returns the phase line, its wrong outputs, the
    add's output, x, y and their modulus, and FheUint64 mul's product round
    (inputs, tables, outputs)."""
    import numpy as np

    from tfhe_tpu_torch.integer import scheduler

    rng = np.random.default_rng(seed)
    mod = isk.msg ** U64_BLOCKS
    x, y, s_mul = (int(v) % mod for v in rng.integers(0, 1 << 64, 3, dtype=np.uint64))
    a64, b64 = ick.encrypt_radix(x, U64_BLOCKS), ick.encrypt_radix(y, U64_BLOCKS)
    cond = ick.encrypt_bool(True)
    log = RoundLog(isk.key, keep=MUL_PRODUCT_ROUND)
    lines, outs = {}, {}
    for name, fn, check in integer_ops(isk, ick, a64, b64, x, y, s_mul, cond, U64_BLOCKS):
        outs[name], lines[name] = measured_op(kernels, log, fn, check)
        check_launches(f"FheUint64 {name}", lines[name],
                       {"keyswitch": None, "keyswitch_imma": "keyswitch", "blind_rotate": None},
                       never=("blind_rotate_multibit", "blind_rotate_exact_lazy"))
    for name, fn in (("add", lambda: isk.add_parallelized(a64, b64)),
                     ("mul", lambda: isk.mul_parallelized(a64, b64))):
        lines[name].update(op_kernel_seconds(fn, KERNEL_NAMES))
    x8, y8 = (int(v) for v in rng.integers(0, 256, 2))
    a8, b8 = ick.encrypt_radix(x8, U8_BLOCKS), ick.encrypt_radix(y8, U8_BLOCKS)
    u8_lines = {}
    for name, fn, want in (
            ("add", lambda: isk.add_parallelized(a8, b8), (x8 + y8) % 256),
            ("mul", lambda: isk.mul_parallelized(a8, b8), (x8 * y8) % 256),
            ("cast", lambda: isk.extend_radix_with_trivial_zero_blocks_msb(
                isk.cast_to_signed(a8, U8_BLOCKS), 2), x8)):
        dec = ick.decrypt_signed_radix if name == "cast" else ick.decrypt_radix
        _, u8_lines[name] = measured_op(kernels, log, fn, lambda o, d=dec, w=want: d(o) != w)
    xs = [int(v) % mod for v in rng.integers(0, 1 << 64, 2 * BATCHED_PAIRS, dtype=np.uint64)]
    xs[1] = xs[0]                  # one equal pair
    pairs = [(ick.encrypt_radix(xs[2 * i], U64_BLOCKS),
              ick.encrypt_radix(xs[2 * i + 1], U64_BLOCKS)) for i in range(BATCHED_PAIRS)]
    batched = {}
    for name, fn, check in (
            ("add_many", lambda: scheduler.add_many_parallelized(isk, pairs),
             lambda o: sum(ick.decrypt_radix(c) != (xs[2 * i] + xs[2 * i + 1]) % mod
                           for i, c in enumerate(o))),
            ("eq_many", lambda: scheduler.eq_many_parallelized(isk, pairs),
             lambda o: sum(ick.decrypt_bool(c) != (xs[2 * i] == xs[2 * i + 1])
                           for i, c in enumerate(o)))):
        _, batched[name] = measured_op(kernels, log, fn, check)
        batched[name]["pbs_per_s"] = batched[name]["pbs"] / batched[name]["seconds"]
    log.close()
    if log.kept is None or len(log.kept[0]) != MUL_PRODUCT_ROUND:
        raise RuntimeError(f"FheUint64 mul ran no product round of {MUL_PRODUCT_ROUND} products")
    wrong = sum(op["wrong"] for group in (lines, u8_lines, batched) for op in group.values())
    line = {"key": "classic V1_4 2_2", "blocks": U64_BLOCKS, "fheuint64": lines,
            "fheuint8": u8_lines, "batched_pairs": BATCHED_PAIRS,
            "batched_fheuint64": batched, "tfhe_rs_h100_ms": TFHE_RS_H100_MS,
            "wrong": wrong}
    return {"line": line, "wrong": wrong, "add_out": outs["add"], "x": x, "y": y,
            "modulus": mod, "product_round": log.kept}


def integer_multibit_phase(kernels, ick, isk, x: int, y: int) -> dict:
    """Phase 15: FheUint64 add and mul on a multi-bit key (K1, then K3 v9,
    every round; K2 never), each timed after a warm-up op and profiled."""
    a, b = ick.encrypt_radix(x, U64_BLOCKS), ick.encrypt_radix(y, U64_BLOCKS)
    log = RoundLog(isk.key)
    lines = {}
    for name, fn, check in integer_ops(isk, ick, a, b, x, y, 0, None, U64_BLOCKS,
                                       only=("add", "mul")):
        _, lines[name] = measured_op(kernels, log, fn, check)
        check_launches(f"multi-bit FheUint64 {name}", lines[name],
                       {"keyswitch": None, "keyswitch_imma": "keyswitch",
                        "blind_rotate_multibit": None}, never=("blind_rotate",))
        lines[name].update(op_kernel_seconds(fn, KERNEL_NAMES))
    log.close()
    return {"key": "multi-bit GROUP_4 2_2", "blocks": U64_BLOCKS, "fheuint64": lines,
            "tfhe_rs_h100_ms": TFHE_RS_H100_MS,
            "wrong": sum(op["wrong"] for op in lines.values())}


STORAGE_STEPS = ("switch_modulus_and_compress", "decompress", "squash")


def integer_storage_phase(kernels, ick, isk, nsk, sq_priv, ct, want: int) -> dict:
    """Phase 16: a FheUint64 through switch_modulus_and_compress (K1 a
    block) and decompress (K2's lazy exact kernel once, B = 32), then
    squashed (K1, then K5 at B = 32) on a squashing key, decrypted with its
    private key."""
    from tfhe_tpu_torch.integer import noise_squashing

    log = RoundLog(isk.key)
    stored, store = measured_op(kernels, log, lambda: isk.switch_modulus_and_compress(ct),
                                lambda o: 0, warm=False)
    check_launches("switch_modulus_and_compress", store,
                   {"keyswitch": None, "keyswitch_imma": "keyswitch"},
                   never=("blind_rotate", "blind_rotate_multibit"))
    _, restore = measured_op(kernels, log, lambda: isk.decompress(stored),
                             lambda o: ick.decrypt_radix(o) != want, warm=False)
    check_launches("radix decompress", restore,
                   {"blind_rotate": None, "blind_rotate_exact_lazy": "blind_rotate"},
                   never=("keyswitch", "blind_rotate_multibit"))
    log.close()
    priv = noise_squashing.NoiseSquashingPrivateKey.__new__(
        noise_squashing.NoiseSquashingPrivateKey)
    priv.key = sq_priv
    squasher = noise_squashing.NoiseSquashingKey.__new__(noise_squashing.NoiseSquashingKey)
    squasher.key = nsk
    _, squash = measured_op(kernels, None,
                            lambda: squasher.squash_radix_ciphertext_noise(isk, ct),
                            lambda o: priv.decrypt_radix(o) != want)
    check_launches("radix squash", squash,
                   {"keyswitch": None, "keyswitch_imma": "keyswitch", "blind_rotate128": None})
    p = isk.params
    return {"blocks": U64_BLOCKS, "switch_modulus_and_compress": store,
            "stored_bytes": sum(c.packed.nbytes for c in stored.blocks),
            "uncompressed_bytes": U64_BLOCKS * (p.big_lwe_dimension + 1) * 8,
            "decompress": restore, "squash": squash,
            "wrong": restore["wrong"] + squash["wrong"]}


def boolean_phase(kernels, tb, seed: int) -> dict:
    """Phase 17: boolean gates at DEFAULT_PARAMETERS (K1's tensor-core
    kernel, then K2's lazy exact kernel once a gate call): keygen, one AND
    gate, GATES packed gates across the six kinds, one mux (two gate
    calls), each timed after a warm-up call.  Returns the phase line, the
    keys, the packed gates' inputs and outputs."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    bck = tb.ClientKey(tb.DEFAULT_PARAMETERS, seed=seed)
    bsk = tb.ServerKey(bck, seed=seed + 1, device="cuda")
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    bits = [bool(v) for v in np.random.default_rng(seed + 2).integers(0, 2, 2 * GATES + 3)]
    kinds = [GATE_KINDS[i % len(GATE_KINDS)] for i in range(GATES)]
    lhs = [bck.encrypt(v) for v in bits[:GATES]]
    rhs = [bck.encrypt(v) for v in bits[GATES:2 * GATES]]
    c_bit, t_bit, f_bit = bits[2 * GATES:]
    mux_in = [bck.encrypt(v) for v in (c_bit, t_bit, f_bit)]
    lines, outs = {}, {}
    for name, fn, check, calls in (
            ("and", lambda: bsk.and_(lhs[0], rhs[0]),
             lambda o: bck.decrypt(o) != (bits[0] and bits[GATES]), 1),
            ("packed", lambda: bsk.gates_packed(kinds, lhs, rhs),
             lambda o: sum(bck.decrypt(g) != GATE_FNS[k](bits[i], bits[GATES + i])
                           for i, (k, g) in enumerate(zip(kinds, o))), 1),
            ("mux", lambda: bsk.mux(*mux_in),
             lambda o: bck.decrypt(o) != (t_bit if c_bit else f_bit), 2)):
        pbs0 = bsk.pbs_count
        outs[name], lines[name] = measured_op(kernels, None, fn, check)
        lines[name]["pbs"] = (bsk.pbs_count - pbs0) // 2          # the timed call's
        lines[name]["gate_calls"] = calls
        check_launches(f"boolean {name}", lines[name],
                       {"keyswitch": None, "keyswitch_imma": "keyswitch", "blind_rotate": None,
                        "blind_rotate_exact_lazy": "blind_rotate"},
                       never=("blind_rotate_multibit",))
        if lines[name]["launches"]["blind_rotate_exact_lazy"] != calls:
            raise RuntimeError(f"boolean {name}: K2's lazy exact kernel did not run once a "
                               f"gate call: {lines[name]['launches']}")
    lines["packed"]["gates_per_s"] = GATES / lines["packed"]["seconds"]
    bp = tb.DEFAULT_PARAMETERS
    line = {"params": "DEFAULT_PARAMETERS", "n": bp.lwe_dimension, "N": bp.polynomial_size,
            "pbs_level": bp.pbs_level, "pbs_base_log": bp.pbs_base_log,
            "ks_level": bp.ks_level, "ks_base_log": bp.ks_base_log,
            "keygen_seconds": keygen_s, "bsk_primes": bsk.dp.num_primes,
            "device_key_bytes": (bsk.ksk.numel() * 8 + bsk.ks_key.limbs.numel()
                                 + key_bytes(bsk.bsk_ntt)),
            "gates": GATES, "kinds": list(GATE_KINDS), **lines,
            "wrong": sum(op["wrong"] for op in lines.values())}
    return {"line": line, "bck": bck, "bsk": bsk, "kinds": kinds, "lhs": lhs, "rhs": rhs,
            "packed_outs": outs["packed"]}


def v7_round_vs_plain(kernels, server, torus, sk, kept, count: int, tag: str,
                      errs: dict) -> None:
    """A round a path ran under a classic key in v7 mode (RoundLog.kept:
    inputs, tables, outputs): its first ``count`` inputs through K1 and K2
    v7 against the plain keyswitch and three-prime v7 rotation, and the
    round's outputs against the plain path (into errs, as k1_<tag>_b<count>,
    k2_v7_<tag>_b<count> and k2_v7_<tag>_outputs_b<count>)."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.shortint.params import MsNoiseReduction
    from tfhe_tpu_torch.shortint.server_key import LookupTable, upload_batch

    dev = torch.device("cuda")
    p = sk.params
    cts, luts, outs = kept
    luts = [luts] * len(cts) if isinstance(luts, LookupTable) else luts
    count = min(count, len(cts))
    m_in = upload_batch([c.data for c in cts[:count]], dev)
    m_ks = kernels.keyswitch(m_in, sk.ks_key, p.ks_base_log, p.ks_level)
    errs[f"k1_{tag}_b{count}"] = max_abs_err(
        m_ks, server.keyswitch(m_in, sk.ksk, p.ks_base_log, p.ks_level))
    log_mod = p.polynomial_size.bit_length()
    body = m_ks[:, -1]
    if p.ms_noise_reduction == MsNoiseReduction.CENTERED_MEAN:
        body = body + server.centered_binary_ms_correction(m_ks, log_mod)
    m_args = (server.modulus_switch(m_ks[:, :-1], log_mod), server.modulus_switch(body, log_mod),
              torus.from_u64(np.stack([t.acc for t in luts[:count]]), dev),
              sk.bsk_ntt, sk.dp, p.pbs_base_log, p.pbs_level, True)
    m_want = server.blind_rotate(*m_args)
    errs[f"k2_v7_{tag}_b{count}"] = max_abs_err(kernels.blind_rotate(*m_args), m_want)
    errs[f"k2_v7_{tag}_outputs_b{count}"] = max_abs_err(
        upload_batch([c.data for c in outs[:count]], dev), server.sample_extract(m_want))


def integer_boolean_vs_plain(kernels, server, ntt, torus, p, sk, product_round, boolean_run,
                             chk, gen, errs: dict) -> dict:
    """The new paths' kernels against their plain versions (into errs):
    FheUint64 mul's product round (B = 1024 under the classic key), its
    first MUL_ROUND_CHECK inputs through K1 and K2 v7 against the plain
    keyswitch and three-prime v7 rotation, and the round's outputs against
    the plain path; the boolean phase's GATES packed gate inputs (their
    linear forms, as gates_packed builds them) through K1 and K2's lazy
    exact kernel against the plain keyswitch and exact rotation, and the
    phase's outputs against the plain path; K2's generic exact kernel at
    tfhe_tpu's TFHE_LIB_PARAMETERS shape on a random key at
    TFHE_LIB_BATCHES.  Returns K2's time, plain time and bound on the gate
    batch."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.shortint.server_key import upload_batch

    dev = torch.device("cuda")
    v7_round_vs_plain(kernels, server, torus, sk, product_round, MUL_ROUND_CHECK,
                      "integer_mul_round", errs)

    bsk = boolean_run["bsk"]
    bp = bsk.params
    gate_in = upload_batch([bsk._binary_lin(k, bsk._materialize(u), bsk._materialize(v))
                            for k, u, v in zip(boolean_run["kinds"], boolean_run["lhs"],
                                               boolean_run["rhs"])], dev)
    ks_plain = server.keyswitch(gate_in, bsk.ksk, bp.ks_base_log, bp.ks_level)
    errs[f"k1_boolean_b{GATES}"] = max_abs_err(
        kernels.keyswitch(gate_in, bsk.ks_key, bp.ks_base_log, bp.ks_level), ks_plain)
    log_mod = bp.polynomial_size.bit_length()
    g_args = (server.modulus_switch(ks_plain[:, :-1], log_mod),
              server.modulus_switch(ks_plain[:, -1], log_mod),
              bsk._sign_lut.expand((GATES,) + tuple(bsk._sign_lut.shape)), bsk.bsk_ntt,
              bsk.dp, bp.pbs_base_log, bp.pbs_level, False)
    lazy_before = kernels.blind_rotate.lazy_exact_launches
    g_got = kernels.blind_rotate(*g_args)
    if kernels.blind_rotate.lazy_exact_launches != lazy_before + 1:
        raise RuntimeError("K2 did not take its lazy exact kernel at the boolean shape")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_want = server.blind_rotate(*g_args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs[f"k2_exact_boolean_b{GATES}"] = max_abs_err(g_got, g_want)
    errs[f"k2_exact_boolean_outputs_b{GATES}"] = max_abs_err(
        upload_batch([g.data for g in boolean_run["packed_outs"]], dev),
        server.sample_extract(g_want))
    del g_got, g_want
    figures = {"ms": cuda_ms(lambda: kernels.blind_rotate(*g_args), 3), "plain_ms": plain_ms,
               "bound": k2_bound(g_args[0], g_args[2], bp.pbs_level, bp.pbs_base_log,
                                 EXACT_PRIMES),
               "shape": [GATES, bp.lwe_dimension, bp.glwe_dimension + 1, bp.polynomial_size]}

    k1_t, n_t, l_t, bl_t, steps_t = TFHE_LIB_SHAPE
    dp_t = ntt.device_plan(ntt.make_plan(n_t, EXACT_PRIMES), "cuda")
    key_t = random_ntt_key((steps_t, l_t, k1_t, k1_t), dp_t, gen)
    for b in TFHE_LIB_BATCHES:
        a = (torch.from_numpy(chk.integers(0, 2 * n_t, (b, steps_t))).to(dev),
             torch.from_numpy(chk.integers(0, 2 * n_t, (b,))).to(dev),
             torus.from_u64(chk.integers(0, 1 << 64, (b, k1_t, n_t), dtype=np.uint64), dev),
             key_t, dp_t, bl_t, l_t, False)
        lazy_before = kernels.blind_rotate.lazy_exact_launches
        errs[f"k2_generic_exact_tfhe_lib_b{b}"] = max_abs_err(kernels.blind_rotate(*a),
                                                              server.blind_rotate(*a))
        if kernels.blind_rotate.lazy_exact_launches != lazy_before:
            raise RuntimeError("K2 took its lazy exact kernel at the TFHE_LIB shape")
    return figures


def radix_words(ct, dev):
    """The block words of a radix ciphertext (or a BooleanBlock) on the card."""
    from tfhe_tpu_torch.shortint.server_key import upload_batch

    blocks = ct.blocks if hasattr(ct, "blocks") else [ct.block]
    return upload_batch([b.data for b in blocks], dev)


# the launches of an op on a classic key in v7 mode: K1's tensor-core kernel
# and K2 v7 every round, K3 and K2's exact kernel never
V7_MUST = {"keyswitch": None, "keyswitch_imma": "keyswitch", "blind_rotate": None}
V7_NEVER = ("blind_rotate_multibit", "blind_rotate_exact_lazy")


def rounds_line(line: dict) -> dict:
    """An op line with its largest round and PBS/s."""
    line["largest_batch"] = max(line.get("batch_sizes") or [0])
    line["pbs_per_s"] = line.get("pbs", 0) / line["seconds"]
    return line


def hlapi_phase(kernels, th, seed: int, integer_lines: dict) -> dict:
    """Phase 18: the high-level API through its entry points.  generate_keys
    at DEFAULT_PARAMS with noise squashing (keygen seconds), set_server_key;
    FheUint64 (32 blocks) add, mul, lt (a FheBool), FheBool &, if_then_else
    and a scalar add, each timed after a warm-up op and decrypted against
    Python integers, beside the integer phase's seconds for the same op
    where it ran one; the add's words against the integer layer's
    add_parallelized on the same ciphertexts under the same key; squash_noise
    of a FheUint64 (K1, then K5 at B = 32), decrypted with decrypt_squashed.
    Returns the phase line, its wrong outputs and the keys."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    ck, sk = th.generate_keys(th.ConfigBuilder().enable_noise_squashing().build(), seed,
                              device="cuda")
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    th.set_server_key(sk)
    key = sk.integer_key.key
    if not key.trunc_acc:
        raise RuntimeError("the hlapi server key did not select v7 mode")
    mod = 1 << 64
    x, y = (int(v) for v in np.random.default_rng(seed).integers(0, mod, 2, dtype=np.uint64))
    a, b = th.FheUint64.encrypt(x, ck), th.FheUint64.encrypt(y, ck)
    yes = th.FheBool.encrypt(True, ck)
    less = a < b
    log = RoundLog(key)
    lines, outs = {}, {}
    for name, fn, want, integer_op in (
            ("add", lambda: a + b, (x + y) % mod, "add"),
            ("mul", lambda: a * b, (x * y) % mod, "mul"),
            ("lt", lambda: a < b, x < y, None),
            ("bool_and", lambda: less & yes, x < y, None),
            ("if_then_else", lambda: less.if_then_else(a, b), min(x, y), "if_then_else"),
            ("scalar_add", lambda: a + HLAPI_SCALAR, (x + HLAPI_SCALAR) % mod, None)):
        outs[name], lines[name] = measured_op(kernels, log, fn,
                                              lambda o, w=want: o.decrypt(ck) != w)
        check_launches(f"hlapi {name}", lines[name], V7_MUST, never=V7_NEVER)
        if integer_op:
            lines[name]["integer_phase_seconds"] = integer_lines[integer_op]["seconds"]
    log.close()
    dev = torch.device("cuda")
    add_words_differ = int((radix_words(outs["add"].inner, dev) != radix_words(
        sk.integer_key.add_parallelized(a.inner, b.inner), dev)).sum())
    _, squash = measured_op(kernels, None, a.squash_noise,
                            lambda o: ck.decrypt_squashed(o) != x)
    check_launches("hlapi squash_noise", squash,
                   {"keyswitch": None, "keyswitch_imma": "keyswitch", "blind_rotate128": None})
    wrong = sum(op["wrong"] for op in lines.values()) + squash["wrong"]
    line = {"params": "DEFAULT_PARAMS", "noise_squashing": "V1_4", "keygen_seconds": keygen_s,
            "blocks": U64_BLOCKS, "fheuint64": lines,
            "add_words_vs_integer_layer_differing": add_words_differ, "squash_noise": squash,
            "wrong": wrong}
    return {"line": line, "wrong": wrong + add_words_differ, "ck": ck, "sk": sk}


def oprf_phase(kernels, th, ck, sk, seed: int) -> dict:
    """Phase 19: the OPRF on the compute key (K2's lazy exact kernel on the
    exact, unrounded key, once a draw; no K1): the exact key's build,
    FheUint64.generate_oblivious_pseudo_random twice from one seed (the same
    words), a 16-bit bounded draw (below 2^16), and bitonic_shuffle of
    SHUFFLE_VALUES FheUint16 values (a permutation of them)."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    key = sk.integer_key.key
    t0 = time.perf_counter()
    key.exact_bsk_ntt()
    torch.cuda.synchronize()
    exact_key_s = time.perf_counter() - t0
    oprf_only = {"blind_rotate": 1, "blind_rotate_exact_lazy": 1}
    block_key = ck.integer_key.key

    def carries_set(o) -> int:
        """Blocks whose whole plaintext (carries too) exceeds the block's
        degree: a drawn block holds a message and empty carries."""
        return sum(block_key.decrypt_raw(b) > b.degree for b in o.inner.blocks)

    draws = []
    for _ in range(2):
        draws.append(measured_op(
            kernels, None, lambda: th.FheUint64.generate_oblivious_pseudo_random(seed),
            carries_set, warm=False))
    bounded = measured_op(
        kernels, None, lambda: th.FheUint64.generate_oblivious_pseudo_random_bounded(seed + 1, 16),
        lambda o: carries_set(o) + (o.decrypt(ck) >= 1 << 16), warm=False)
    for tag, (_, line) in (("draw", draws[0]), ("repeat", draws[1]), ("bounded", bounded)):
        if line["launches"] != oprf_only:
            raise RuntimeError(f"the OPRF {tag} did not run K2's lazy exact kernel alone, "
                               f"once: {line['launches']}")
    repeat_differ = int((radix_words(draws[0][0].inner, dev)
                         != radix_words(draws[1][0].inner, dev)).sum())
    vals = [int(v) for v in np.random.default_rng(seed + 2).integers(0, 1 << 16, SHUFFLE_VALUES)]
    enc = [th.FheUint16.encrypt(v, ck) for v in vals]
    log = RoundLog(key)
    shuffled, shuffle = measured_op(
        kernels, log, lambda: th.bitonic_shuffle(enc, seed=seed + 3),
        lambda o: sorted(c.decrypt(ck) for c in o) != sorted(vals), warm=False)
    log.close()
    check_launches("bitonic_shuffle", shuffle,
                   {"keyswitch": None, "keyswitch_imma": "keyswitch", "blind_rotate": None,
                    "blind_rotate_exact_lazy": None}, never=("blind_rotate_multibit",))
    wrong = draws[0][1]["wrong"] + draws[1][1]["wrong"] + bounded[1]["wrong"] + shuffle["wrong"]
    line = {"exact_key_seconds": exact_key_s, "draw": draws[0][1], "repeat": draws[1][1],
            "repeat_words_differing": repeat_differ, "bounded_16_bits": bounded[1],
            "shuffle_values": SHUFFLE_VALUES, "bitonic_shuffle": rounds_line(shuffle),
            "wrong": wrong}
    return {"line": line, "wrong": wrong + repeat_differ, "seed": seed, "draw": draws[0][0]}


def compressed_key_phase(kernels, th, ck, seed: int) -> dict:
    """Phase 20: a CompressedServerKey on the hlapi client key (seeded KSK
    and BSK, the BSK floored at 15 as the server key's): its stored bytes
    against the full key's, keygen and decompress seconds (the decompressed
    key must run v7 mode), and one FheUint64 add under it, decrypted."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    csk = th.CompressedServerKey(ck, seed)
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dsk = csk.decompress(device="cuda")
    torch.cuda.synchronize()
    decompress_s = time.perf_counter() - t0
    key = dsk.integer_key.key
    if not key.trunc_acc or key._bsk_floored != 15:
        raise RuntimeError("the decompressed key is not floored at 15 in v7 mode")
    p = key.params
    full_bytes = 8 * (p.big_lwe_dimension * p.ks_level * (p.lwe_dimension + 1)
                      + p.lwe_dimension * p.pbs_level * (p.glwe_dimension + 1) ** 2
                      * p.polynomial_size)
    mod = 1 << 64
    x, y = (int(v) for v in np.random.default_rng(seed).integers(0, mod, 2, dtype=np.uint64))
    log = RoundLog(key)
    with th.with_server_key_as_context(dsk):
        a, b = th.FheUint64.encrypt(x, ck), th.FheUint64.encrypt(y, ck)
        _, add = measured_op(kernels, log, lambda: a + b,
                             lambda o: o.decrypt(ck) != (x + y) % mod)
    log.close()
    check_launches("add under the decompressed key", add, V7_MUST, never=V7_NEVER)
    line = {"stored_bytes": csk._compressed.nbytes, "full_key_bytes": full_bytes,
            "ratio": full_bytes / csk._compressed.nbytes, "keygen_seconds": keygen_s,
            "decompress_seconds": decompress_s, "bsk_floored": key._bsk_floored,
            "v7_mode": key.trunc_acc, "fheuint64_add": add, "wrong": add["wrong"]}
    return {"line": line, "wrong": add["wrong"]}


def kv_store_phase(kernels, th, kv_store, ck, sk, seed: int) -> dict:
    """Phase 21: a KVStore of KV_ENTRIES clear u32 keys to FheUint64 values:
    get of a present and of an absent encrypted key and one update, each a
    few coalesced rounds over every entry (the scheduler's eq_many and
    if_then_else_many, then a carry-save sum); and an FheUintArray add of
    ARRAY_PAIRS FheUint32 pairs (one scheduler call).  Every result
    decrypted."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ik, isk = ck.integer_key, sk.integer_key
    mod = 1 << 64
    keys = [int(k) for k in rng.choice(1 << 32, KV_ENTRIES + 1, replace=False)]
    keys, absent = keys[:-1], keys[-1]
    values = [int(v) for v in rng.integers(0, mod, KV_ENTRIES + 1, dtype=np.uint64)]
    values, new_value = values[:-1], values[-1]
    t0 = time.perf_counter()
    store = kv_store.KVStore(isk, U64_BLOCKS)
    for k, v in zip(keys, values):
        store.insert_clear_key(k, ik.encrypt_radix(v, U64_BLOCKS))
    fill_s = time.perf_counter() - t0
    present = keys[KV_ENTRIES // 3]
    enc_present = ik.encrypt_radix(present, KV_KEY_BLOCKS)
    enc_absent = ik.encrypt_radix(absent, KV_KEY_BLOCKS)
    enc_new = ik.encrypt_radix(new_value, U64_BLOCKS)
    log = RoundLog(isk.key)
    lines = {}
    for name, fn, check in (
            ("get_present", lambda: store.get(enc_present),
             lambda o: ik.decrypt_radix(o) != values[KV_ENTRIES // 3]),
            ("get_absent", lambda: store.get(enc_absent), lambda o: ik.decrypt_radix(o) != 0),
            ("update", lambda: store.update(enc_present, enc_new),
             lambda o: ik.decrypt_radix(store.get_with_clear_key(present)) != new_value)):
        _, lines[name] = measured_op(kernels, log, fn, check, warm=False)
        check_launches(f"KVStore {name}", rounds_line(lines[name]), V7_MUST, never=V7_NEVER)
    lines["update"]["others_changed"] = sum(
        ik.decrypt_radix(store.get_with_clear_key(k)) != v
        for k, v in zip(keys[:8], values[:8]) if k != present)
    xs = [int(v) for v in rng.integers(0, 1 << 32, 2 * ARRAY_PAIRS)]
    arr_a = th.FheUintArray.encrypt(xs[:ARRAY_PAIRS], th.FheUint32, ck)
    arr_b = th.FheUintArray.encrypt(xs[ARRAY_PAIRS:], th.FheUint32, ck)
    _, lines["array_add"] = measured_op(
        kernels, log, lambda: arr_a + arr_b,
        lambda o: sum(int(v) != (p + q) % (1 << 32) for v, p, q in
                      zip(o.decrypt(ck), xs[:ARRAY_PAIRS], xs[ARRAY_PAIRS:])), warm=False)
    check_launches("FheUintArray add", rounds_line(lines["array_add"]), V7_MUST, never=V7_NEVER)
    log.close()
    wrong = sum(op["wrong"] for op in lines.values()) + lines["update"]["others_changed"]
    line = {"entries": KV_ENTRIES, "key_blocks": KV_KEY_BLOCKS, "value_blocks": U64_BLOCKS,
            "fill_seconds": fill_s, "array_pairs": ARRAY_PAIRS, **lines, "wrong": wrong}
    return {"line": line, "wrong": wrong}


def strings_phase(kernels, th, strings, ck, sk) -> dict:
    """Phase 22: FheAsciiStrings: eq of STRING_TEXT and STRING_PADDED (with
    STRING_PADS hidden nul pads), contains and find of a 3-character clear
    pattern in STRING_TEXT, its to_uppercase, trim of STRING_PADDED and
    split(".") of STRING_SPLIT, each decrypted and held to Python's str;
    per-character calls are each their own rounds, as in tfhe_tpu.
    Returns the phase line, its wrong outputs and the first round's inputs,
    tables and outputs."""
    text, padded = STRING_TEXT, STRING_PADDED
    s1 = th.FheAsciiString.encrypt(text, ck)
    s2 = th.FheAsciiString.encrypt(padded, ck, padding=STRING_PADS)
    s3 = th.FheAsciiString.encrypt(STRING_SPLIT, ck)
    ssk = strings.StringServerKey(sk.integer_key)

    def fields(pieces):
        return [th.FheAsciiString(f).decrypt(ck) for f, some in pieces
                if ck.integer_key.decrypt_bool(some)]

    log = RoundLog(sk.integer_key.key, keep="first")
    lines = {}
    for name, fn, check in (
            ("eq", lambda: s1.eq(s2), lambda o: o.decrypt(ck) != (text == padded)),
            ("contains", lambda: s1.contains(STRING_PATTERN),
             lambda o: o.decrypt(ck) != (STRING_PATTERN in text)),
            ("find", lambda: s1.find(STRING_PATTERN),
             lambda o: (o[0].decrypt(ck), o[1].decrypt(ck)) != (True, text.find(STRING_PATTERN))),
            ("to_uppercase", s1.to_uppercase, lambda o: o.decrypt(ck) != text.upper()),
            ("trim", s2.trim, lambda o: o.decrypt(ck) != padded.strip()),
            ("split", lambda: ssk.split(s3.inner, "."),
             lambda o: fields(o) != STRING_SPLIT.split("."))):
        _, lines[name] = measured_op(kernels, log, fn, check, warm=False)
        check_launches(f"string {name}", rounds_line(lines[name]), V7_MUST, never=V7_NEVER)
    log.close()
    wrong = sum(op["wrong"] for op in lines.values())
    line = {"chars": len(text), "padded_chars": len(padded), "pads": STRING_PADS,
            "split_chars": len(STRING_SPLIT), "pattern": STRING_PATTERN, **lines,
            "wrong": wrong}
    return {"line": line, "wrong": wrong, "first_round": log.kept}


def hlapi_paths_vs_plain(kernels, server, torus, sk, oprf_seed: int, oprf_draw,
                         string_round, errs: dict) -> None:
    """The hlapi paths' kernels against their plain versions (into errs):
    K2's lazy exact kernel on the OPRF draw's own switched inputs and LUTs
    (the exact key, B = 32) against the plain exact rotation; phase 19's
    drawn FheUint64 against the plain path on those inputs (the plain
    rotation, sample extraction, each block's post-rotation constant); and
    one string round (its first STRING_ROUND_CHECK inputs) through K1 and
    K2 v7."""
    import numpy as np

    from tfhe_tpu_torch.shortint import oprf

    key = sk.integer_key.key
    ok = oprf.OprfServerKey.from_compute_key(key)
    p = key.params
    msed, luts, posts = ok.switched_inputs(oprf_seed, [(p.message_modulus - 1).bit_length()]
                                           * U64_BLOCKS)
    args = (msed[:, :-1], msed[:, -1], luts, ok.bsk_ntt, ok.dp, p.pbs_base_log, p.pbs_level)
    lazy_before = kernels.blind_rotate.lazy_exact_launches
    got = kernels.blind_rotate(*args)
    if kernels.blind_rotate.lazy_exact_launches != lazy_before + 1:
        raise RuntimeError("K2 did not take its lazy exact kernel on the OPRF's inputs")
    want = server.blind_rotate(*args)
    errs[f"k2_exact_oprf_b{msed.shape[0]}"] = max_abs_err(got, want)
    plain_draw = server.sample_extract(want)[:len(posts)].clone()
    plain_draw[:, -1] += torus.from_u64(np.array(posts, dtype=np.uint64), plain_draw.device)
    errs[f"oprf_draw_vs_plain_path_b{len(posts)}"] = max_abs_err(
        radix_words(oprf_draw.inner, plain_draw.device), plain_draw)
    v7_round_vs_plain(kernels, server, torus, key, string_round, STRING_ROUND_CHECK,
                      "string_round", errs)


def compact_pke_phase(kernels, th, ck, sk, seed: int) -> dict:
    """Phase 23: config 5 on the hlapi keys.  Keygen of the V1_4 ZKV2 PKE
    private and public keys and both casting keys (the casts' K1 byte
    layout built on the card), a v2 CRS for CRS_SLOTS slots; two proven
    lists of one FheUint64 each (its 2-bit blocks) from fixed seeds
    (prove seconds a list), each verified and expanded (one batched
    extraction, no kernel), the 64 slots cast to the small key in one call
    (K1's tensor-core kernel at n_in = 2048, l = 4, then K2's lazy exact
    kernel on the exact key), and the two FheUint64 added through the
    hlapi; a plain list of PKE_FULL_SLOTS slots expanded and cast at B =
    PKE_FULL_SLOTS; the first list's slots cast to the big key (K1's
    generic kernel, base 2^24, l = 1); re-randomization of 32 ciphertexts
    with a compute-key compact public key.  Every slot is decrypted.
    Returns the phase line, its wrong outputs and the casts' inputs."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.hlapi import compact_list as cl
    from tfhe_tpu_torch.hlapi import proven_compact_list as pcl
    from tfhe_tpu_torch.integer import RadixCiphertext
    from tfhe_tpu_torch.shortint import params as sp
    from tfhe_tpu_torch.shortint import re_randomization as rr
    from tfhe_tpu_torch.shortint.server_key import upload_batch

    pke_p = sp.V1_4_PARAM_PKE_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2
    blk, key = ck.integer_key.key, sk.integer_key.key
    seconds = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    priv = timed("private_key", lambda: cl.CompactPrivateKey(pke_p, seed))
    cpk = timed("public_key", lambda: cl.CompactPublicKey(priv, seed + 1))
    small = timed("casting_key_small", lambda: cl.CompactPkeCastingKey(
        priv, ck, sp.V1_4_PARAM_KEYSWITCH_PKE_TO_SMALL_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
        server_key=sk, seed=seed + 2))
    big = timed("casting_key_big", lambda: cl.CompactPkeCastingKey(
        priv, ck, sp.V1_4_PARAM_KEYSWITCH_PKE_TO_BIG_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
        seed=seed + 3, device="cuda"))
    if not (isinstance(small.ks_key, kernels.KeyswitchKeyLimbs)
            and isinstance(big.ks_key, kernels.KeyswitchKeyLimbs)):
        raise RuntimeError("the casting keys do not hold K1's byte layouts: the cast to small "
                           "for its tensor-core kernel, to big for its limb-row kernel")
    crs = timed("crs_v2", lambda: pcl.CompactPkeCrs.new(pke_p, CRS_SLOTS, seed + 4, "v2"))
    timed("exact_key", key.exact_bsk_ntt)
    mod = 1 << 64
    x, y = (int(v) for v in np.random.default_rng(seed + 5).integers(0, mod, 2, dtype=np.uint64))

    def digits(v: int) -> list:
        return [(v >> (2 * i)) & 3 for i in range(PKE_SLOTS)]

    proofs, slots, launches = [], [], {}
    for i, (v, s) in enumerate(((x, seed + 6), (y, seed + 7))):
        lst = timed(f"prove_{i}", lambda v=v, s=s: pcl.build_with_proof(
            cpk, digits(v), crs, PKE_METADATA, seed=s))
        if not timed(f"verify_{i}", lambda lst=lst: lst.verify(crs, cpk, PKE_METADATA)):
            raise RuntimeError(f"proven list {i} did not verify")
        out, launches[f"expand_{i}"], seconds[f"expand_{i}"], _ = counted(
            kernels, lambda lst=lst: lst.expand_without_verification(device="cuda"))
        proofs.append(lst)
        slots += out
    want = digits(x) + digits(y)
    cast, launches["cast_small_b64"], seconds["cast_small_b64"], _ = counted(
        kernels, lambda: small.cast_batch(slots))
    cast_only = only(kernels, keyswitch=1, keyswitch_imma=1, blind_rotate=1,
                     blind_rotate_exact_lazy=1)
    if launches["cast_small_b64"] != cast_only:
        raise RuntimeError(f"the cast to small did not run K1's tensor-core kernel and K2's "
                           f"lazy exact kernel once each: {launches['cast_small_b64']}")
    if any(any(launches[f"expand_{i}"].values()) for i in range(2)):
        raise RuntimeError("the expansion launched a kernel")
    wrong = {"cast_small_b64": sum(blk.decrypt(c) != w for c, w in zip(cast, want))}
    dev = torch.device("cuda")
    # the cast's words as it gave them (the integer ops below take its blocks)
    cast_words = upload_batch([c.data for c in cast], dev)
    th.set_server_key(sk)
    a = th.FheUint64(RadixCiphertext(cast[:PKE_SLOTS]))
    b = th.FheUint64(RadixCiphertext(cast[PKE_SLOTS:]))
    log = RoundLog(key)
    _, add = measured_op(kernels, log, lambda: a + b, lambda o: o.decrypt(ck) != (x + y) % mod,
                         warm=False)
    log.close()
    check_launches("add of the cast FheUint64s", add, V7_MUST, never=V7_NEVER)
    wrong["fheuint64_add"] = add["wrong"]
    # a plain list of a full polynomial of slots, cast at B = PKE_FULL_SLOTS
    full = [int(v) for v in np.random.default_rng(seed + 8).integers(0, 4, PKE_FULL_SLOTS)]
    full_lst = timed("encrypt_full_list", lambda: cpk.encrypt_list(full))
    full_slots, launches["expand_full"], seconds["expand_full"], _ = counted(
        kernels, lambda: cl.expanded_slots(full_lst.glwe, range(PKE_FULL_SLOTS), 4, 4,
                                           torch.device("cuda")))
    full_cast, launches["cast_small_full"], seconds["cast_small_full"], _ = counted(
        kernels, lambda: small.cast_batch(full_slots))
    if launches["cast_small_full"] != cast_only:
        raise RuntimeError(f"the full cast did not run K1's tensor-core kernel and K2's lazy "
                           f"exact kernel once each: {launches['cast_small_full']}")
    wrong["cast_small_full"] = sum(blk.decrypt(c) != w for c, w in zip(full_cast, full))
    # the first list's slots cast to the big key (K1's limb-row kernel)
    to_big, launches["cast_big_b32"], seconds["cast_big_b32"], _ = counted(
        kernels, lambda: big.cast_batch(slots[:PKE_SLOTS]))
    if launches["cast_big_b32"] != only(kernels, keyswitch=1, keyswitch_limbs=1):
        raise RuntimeError(f"the cast to big did not run K1's limb-row kernel alone, once: "
                           f"{launches['cast_big_b32']}")
    wrong["cast_big_b32"] = sum(blk.decrypt(c) != w for c, w in zip(to_big, want))
    # re-randomization of the cast FheUint64's 32 blocks
    rkey = timed("rerand_public_key", lambda: rr.ReRandomizationKey(cl.CompactPublicKey(
        ck, seed + 9)))
    rer, launches["re_randomize"], seconds["re_randomize"], _ = counted(
        kernels, lambda: rkey.re_randomize_batch(cast[:PKE_SLOTS], b"chip_smoke", b"ctx",
                                           device="cuda"))
    if any(launches["re_randomize"].values()):
        raise RuntimeError("re-randomization launched a kernel")
    wrong["re_randomize"] = sum(blk.decrypt(c) != w for c, w in zip(rer, want))
    rerand_unchanged = int((upload_batch([c.data for c in rer], dev)
                            == cast_words[:PKE_SLOTS]).all(dim=1).sum())
    per_list = {k: [seconds[f"{k}_{i}"] for i in range(2)] for k in ("prove", "verify",
                                                                     "expand")}
    line = {
        "pke_params": "V1_4_PARAM_PKE_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2",
        "d": pke_p.polynomial_size, "noise_bound_log2": pke_p.encryption_noise.bound_log2,
        "crs_slots": CRS_SLOTS, "slots_per_list": PKE_SLOTS, "full_slots": PKE_FULL_SLOTS,
        "keygen_seconds": {k: seconds[k] for k in ("private_key", "public_key",
                                                   "casting_key_small", "casting_key_big")},
        "crs_seconds": seconds["crs_v2"], "exact_key_seconds": seconds["exact_key"],
        "prove_seconds": per_list["prove"], "verify_seconds": per_list["verify"],
        "expand_seconds": per_list["expand"],
        "verify_and_expand_seconds": [v + e for v, e in zip(per_list["verify"],
                                                            per_list["expand"])],
        "cast_small_b64_seconds": seconds["cast_small_b64"], "fheuint64_add": add,
        "encrypt_full_list_seconds": seconds["encrypt_full_list"],
        "expand_full_seconds": seconds["expand_full"],
        "cast_small_full_seconds": seconds["cast_small_full"],
        "full_slots_per_s": PKE_FULL_SLOTS / (seconds["expand_full"]
                                              + seconds["cast_small_full"]),
        "cast_big_b32_seconds": seconds["cast_big_b32"],
        "re_randomize_seconds": seconds["re_randomize"],
        "re_randomized_unchanged": rerand_unchanged,
        "launches": launches,
        "tfhe_rs_cpu_ms_one_fheuint64": TFHE_RS_ZK_CPU_MS,
        "port_ms_one_fheuint64": {
            "prove": 1e3 * min(per_list["prove"]), "verify": 1e3 * min(per_list["verify"]),
            "verify_and_expand": 1e3 * min(v + e for v, e in zip(per_list["verify"],
                                                                 per_list["expand"])),
            "verify_expand_and_cast": 1e3 * (min(per_list["verify"]) + min(per_list["expand"])
                                             + seconds["cast_small_b64"] / 2)},
        "wrong": wrong}
    return {"line": line, "wrong": sum(wrong.values()) + rerand_unchanged,
            "small": small, "big": big, "slots": slots, "cast": cast_words,
            "full_slots": full_slots, "full_cast": upload_batch([c.data for c in full_cast], dev),
            "to_big": upload_batch([c.data for c in to_big], dev)}


def trivium_phase(kernels, trivium, bck, bsk, seed: int) -> dict:
    """Phase 24: Trivium and Kreyvium over the boolean gates at
    DEFAULT_PARAMETERS (phase 17's keys).  Each stream starts from the
    encrypted post-warm-up state of a clear stream (set through __new__),
    runs TRIVIUM_STEPS keystream steps, then transcipher_decrypt of as many
    clear cipher bits; every bit is held against the clear stream.  Gate
    calls are K1 launches, each followed by one of K2's lazy exact kernel."""
    import numpy as np

    lines, wrong = {}, 0
    for name, cls_name, bits in TRIVIUM_STREAMS:
        cls = getattr(trivium, cls_name)
        rng = np.random.default_rng(seed + bits)
        key_bits, iv_bits = ([bool(v) for v in rng.integers(0, 2, bits)] for _ in range(2))
        t0 = time.perf_counter()
        clear = cls(key_bits, iv_bits)
        clear_warmup_s = time.perf_counter() - t0
        enc = cls.__new__(cls)
        enc.be = trivium._Backend(bsk)
        for reg in ("s1", "s2", "s3", "kstar", "ivstar"):
            if hasattr(clear, reg):
                setattr(enc, reg, [bck.encrypt(v) for v in getattr(clear, reg)])
        stream_bits = clear.next_bits(TRIVIUM_STEPS)
        cipher = [bool(v) for v in rng.integers(0, 2, TRIVIUM_STEPS)]
        plain = [c != k for c, k in zip(cipher, clear.next_bits(TRIVIUM_STEPS))]
        step = {}
        for tag, fn, want in (("keystream", lambda: enc.next_bits(TRIVIUM_STEPS), stream_bits),
                              ("transcipher", lambda: trivium.transcipher_decrypt(
                                  enc, cipher, bsk), plain)):
            _, step[tag] = measured_op(
                kernels, None, fn,
                lambda o, want=want: sum(bck.decrypt(c) != w for c, w in zip(o, want)),
                warm=False)
            got = step[tag]["launches"]
            check_launches(f"{name} {tag}", step[tag],
                           {"keyswitch": None, "keyswitch_imma": "keyswitch",
                            "blind_rotate": "keyswitch",
                            "blind_rotate_exact_lazy": "keyswitch"},
                           never=("blind_rotate_multibit",))
            step[tag].update({"steps": TRIVIUM_STEPS,
                              "seconds_per_step": step[tag]["seconds"] / TRIVIUM_STEPS,
                              "gate_calls": got["keyswitch"],
                              "gate_calls_per_step": got["keyswitch"] / TRIVIUM_STEPS,
                              "seconds_per_gate_call": step[tag]["seconds"] / got["keyswitch"]})
            wrong += step[tag]["wrong"]
        per_step = step["keystream"]["seconds_per_step"]
        lines[name] = {**step, "clear_warmup_seconds": clear_warmup_s,
                       "warmup_steps": TRIVIUM_WARMUP_STEPS,
                       "warmup_projection_seconds": TRIVIUM_WARMUP_STEPS * per_step}
    return {"line": {"params": "DEFAULT_PARAMETERS", **lines, "wrong": wrong},
            "wrong": wrong}


def compact_paths_vs_plain(kernels, server, torus, sk, run, errs: dict) -> dict:
    """Phase 23's casts against their plain versions (into errs): K1 on the
    64 proven slots (tensor-core kernel, n_in = 2048, l = 4, base 2^4) and on
    the 32 slots cast to big (generic kernel, l = 1, base 2^24) against the
    plain keyswitch; K2's lazy exact kernel on the 64 slots' switched
    inputs against the plain exact rotation; the cast outputs (their words
    as the casts gave them) against the plain path (plain keyswitch,
    modulus switch, rotation, extraction).
    Returns K1's figures at the cast shapes (B = 64, B = PKE_FULL_SLOTS and
    the cast to big at B = 32) and K2's at B = 64 and B = PKE_FULL_SLOTS."""
    import torch

    from tfhe_tpu_torch.shortint.params import MsNoiseReduction
    from tfhe_tpu_torch.shortint.server_key import upload_batch

    key = sk.integer_key.key
    p = key.params
    dev = torch.device("cuda")
    small, big = run["small"], run["big"]
    figs = {}
    for tag, cast_key, rows, outs in (
            ("small_b64", small, run["slots"], run["cast"]),
            (f"small_b{PKE_FULL_SLOTS}", small, run["full_slots"], run["full_cast"]),
            ("big_b32", big, run["slots"][:PKE_SLOTS], run["to_big"])):
        kp = cast_key.params
        ct = upload_batch([c.data for c in rows], dev)
        kargs = (ct, cast_key.ks_key, kp.ks_base_log, kp.ks_level)
        pargs = (ct, cast_key.ksk, kp.ks_base_log, kp.ks_level)
        imma_before = kernels.keyswitch.imma_launches
        limb_before = kernels.keyswitch.limb_launches
        got = kernels.keyswitch(*kargs)
        imma = kernels.keyswitch.imma_launches != imma_before
        limb = kernels.keyswitch.limb_launches != limb_before
        if imma != (kp.destination_key == "small") or limb == imma:
            raise RuntimeError(f"K1 at the cast shape {tag} took the wrong kernel")
        want = server.keyswitch(*pargs)
        errs[f"k1_cast_{tag}"] = max_abs_err(got, want)
        fig = {"kernel": "keyswitch_imma_kernel" if imma else "keyswitch_limbs_kernel",
               "shape": [ct.shape[0]] + list(cast_key.ksk.shape),
               "base_log": kp.ks_base_log,
               "ms": cuda_ms(lambda: kernels.keyswitch(*kargs), 10),
               "plain_ms": cuda_ms(lambda: server.keyswitch(*pargs), 3),
               "library_ms": cuda_ms(lambda: int_mm_keyswitch(*pargs), 10) if imma else None}
        bound = k1_bound(ct, cast_key.ksk, got, kp.ks_base_log)
        fig.update({"bound_ms": bound["ms"], "bound_by": bound["by"],
                    "bound_bytes_ms": bound["bytes_ms"]})
        fig["share_of_bound"] = fig["bound_ms"] / fig["ms"]
        if not imma:
            # the limb-row kernel against the generic kernel it replaced,
            # in turns, its C entry alone and its int8 yardstick
            fig.update(limb_route_figures(kernels, server, ct, cast_key.ksk, cast_key.ks_key,
                                          kp.ks_base_log, kp.ks_level))
            fig["share_of_bound"] = fig["bound_ms"] / fig["ms"]
            errs.update({f"k1_cast_{tag}_{name}": v
                         for name, v in fig["words_differing"].items()})
        if kp.destination_key == "big":
            errs[f"cast_{tag}_vs_plain_path"] = max_abs_err(outs, want)
            figs[tag] = fig
            continue
        # the refresh: K2's lazy exact kernel on the switched keyswitch output
        log_mod = p.polynomial_size.bit_length()
        body = want[:, -1]
        if p.ms_noise_reduction == MsNoiseReduction.CENTERED_MEAN:
            body = body + server.centered_binary_ms_correction(want, log_mod)
        msed_mask = server.modulus_switch(want[:, :-1], log_mod)
        body = server.modulus_switch(body, log_mod)
        lut = torus.from_u64(key.generate_lookup_table(lambda v: v).acc, dev)
        lut = lut.expand((ct.shape[0],) + tuple(lut.shape)).contiguous()
        exact = key.exact_bsk_ntt()
        rargs = (msed_mask, body, lut, exact, key.dp, p.pbs_base_log, p.pbs_level)
        lazy_before = kernels.blind_rotate.lazy_exact_launches
        acc = kernels.blind_rotate(*rargs)
        if kernels.blind_rotate.lazy_exact_launches != lazy_before + 1:
            raise RuntimeError("the cast's refresh did not take K2's lazy exact kernel")
        plain_acc, plain_ms = None, None
        if tag == "small_b64":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            plain_acc = server.blind_rotate(*rargs)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
        if plain_acc is not None:
            errs["k2_exact_cast_b64"] = max_abs_err(acc, plain_acc)
            errs["cast_small_b64_vs_plain_path"] = max_abs_err(
                outs, server.sample_extract(plain_acc))
        k2b = k2_bound(msed_mask, lut, p.pbs_level, p.pbs_base_log, EXACT_PRIMES)
        fig["k2_exact"] = {"ms": cuda_ms(lambda: kernels.blind_rotate(*rargs), 3),
                           "plain_ms": plain_ms,
                           "bound_ms": k2b["ms"], "bound_by": k2b["by"],
                           "shape": [ct.shape[0], p.lwe_dimension, p.glwe_dimension + 1,
                                     p.polynomial_size]}
        figs[tag] = fig
    return figs


# the atomic-pattern phase's sets (tfhe_tpu_torch/shortint/params.py), each
# with the kernels its round must run; V1_4 KS32 and PBS->KS decrypt at
# random in tfhe_tpu too (their noise is uniform on the torus: ROADMAP.md
# queue 3), so only their words are checked, against the plain path
ATOMIC_SETS = (
    ("ks32", "V1_4_PARAM_MESSAGE_2_CARRY_2_KS32_PBS_TUNIFORM_2M128", False),
    ("pbs_ks", "V1_4_PARAM_MESSAGE_2_CARRY_2_PBS_KS_GAUSSIAN_2M128", False),
    ("ks_pbs_2m64", "V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M64", True),
    ("ks_pbs_2m40", "V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M40", True),
    ("ks_pbs_gaussian", "V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_GAUSSIAN_2M128", True),
    ("test_ks32", "TEST_PARAM_MESSAGE_2_CARRY_2_KS32", True),
    ("test_pbs_ks", "TEST_PARAM_MESSAGE_2_CARRY_2_PBS_KS", True),
)
# what each set's round must launch (counter: the launches of another it
# must equal, or None for at least once) and never
ATOMIC_MUST = {
    "ks32": ({"keyswitch32": None, "keyswitch32_imma": "keyswitch32", "blind_rotate": None},
             ("keyswitch", "blind_rotate_exact_lazy", "blind_rotate_multibit")),
    "pbs_ks": ({"keyswitch": None, "keyswitch_imma": "keyswitch",
                "blind_rotate_exact_lazy": "blind_rotate"}, ("keyswitch32",)),
    "ks_pbs": ({"keyswitch": None, "keyswitch_imma": "keyswitch", "blind_rotate": None},
               ("keyswitch32", "blind_rotate_exact_lazy", "blind_rotate_multibit")),
    "test_ks32": ({"keyswitch32": None, "keyswitch32_imma": "keyswitch32",
                   "blind_rotate": None}, ("keyswitch", "blind_rotate_exact_lazy")),
    "test_pbs_ks": ({"keyswitch": None, "keyswitch_imma": "keyswitch", "blind_rotate": None},
                    ("keyswitch32", "blind_rotate_exact_lazy")),
    "many_ks32": ({"keyswitch32": None, "keyswitch32_imma": "keyswitch32",
                   "blind_rotate_exact_lazy": "blind_rotate"},
                  ("keyswitch", "blind_rotate_multibit")),
    "many_classic": ({"keyswitch": None, "keyswitch_imma": "keyswitch",
                      "blind_rotate_exact_lazy": "blind_rotate"},
                     ("keyswitch32", "blind_rotate_multibit")),
    "many_multibit": ({"keyswitch": None, "keyswitch_imma": "keyswitch",
                       "blind_rotate_multibit": None}, ("keyswitch32", "blind_rotate")),
    "drift": ({"keyswitch": None, "keyswitch_imma": "keyswitch", "blind_rotate": None},
              ("keyswitch32", "blind_rotate_exact_lazy")),
}
# the plain comparisons' batch (the plain v7 rotation at B = 512 takes
# seconds), and the drift set's zero-encryptions (tests/test_shortint.py:150)
PLAIN_BATCH = 32
DRIFT_ZEROS = 16
MANY_FNS = (lambda x: x % 4, lambda x: (x + 1) % 4)


def plain_kernels(kernels, server):
    """A context in which every kernel wrapper the atomic patterns reach runs
    its plain PyTorch version on the card (the same tensors, no launch):
    the entry points then give the plain path's words."""
    import contextlib

    def words(k):
        return k.words if isinstance(k, kernels.KeyswitchKeyLimbs) else k

    def mb(degrees, body, lut, key, dp, base_log, levels, v9=False):
        fn = server.blind_rotate_multibit_v9 if v9 else server.blind_rotate_multibit
        return fn(degrees, body, lut, key, dp, base_log, levels)

    swaps = {"keyswitch": lambda ct, k, b, l: server.keyswitch(ct, words(k), b, l),
             "keyswitch32": lambda ct, k, b, l: server.keyswitch32(ct, words(k), b, l),
             "blind_rotate": server.blind_rotate, "blind_rotate_multibit": mb}

    @contextlib.contextmanager
    def ctx():
        saved = {name: getattr(kernels, name) for name in swaps}
        try:
            for name, fn in swaps.items():
                setattr(kernels, name, fn)
            yield
        finally:
            for name, fn in saved.items():
                setattr(kernels, name, fn)
    return ctx()


def pattern_rounds(kernels, ck, sk, seed: int, run, want_fn, decrypts: bool,
                   plain: bool = True) -> dict:
    """ROUNDS calls of run(sk, cts) at B = BATCH on one batch of
    encryptions (host encryption at full width is the phase's largest
    cost; each call is a whole round all the same): seconds, PBS/s, the
    launches of the calls, each output decrypted against want_fn where the
    set decrypts; then, where plain, the first PLAIN_BATCH inputs through
    the same entry point with the kernels and with their plain versions
    (the words' largest difference, and the plain path's seconds)."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import server
    from tfhe_tpu_torch.shortint.server_key import upload_batch

    inputs = np.random.default_rng(seed).integers(0, sk.params.message_modulus, BATCH)
    cts = [ck.encrypt(int(v)) for v in inputs]
    reset_counts(kernels)
    torch.cuda.synchronize()
    round_s, outs = [], []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        outs.append(run(sk, cts))
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
    launches = read_counts(kernels)
    wrong = 0
    if decrypts:
        for out_r in outs:
            for out, v in zip(out_r, inputs):
                wrong += want_fn(ck, out, int(v))
    line = {"batch": BATCH, "rounds": ROUNDS, "round_seconds": round_s,
            "pbs_per_s": ROUNDS * BATCH / sum(round_s),
            "pbs_per_s_after_first": (ROUNDS - 1) * BATCH / sum(round_s[1:]),
            "launches": {k: v for k, v in launches.items() if v},
            "outputs_checked": ROUNDS * BATCH if decrypts else 0, "wrong": wrong}
    if not plain:
        return line
    few = cts[:PLAIN_BATCH]

    def flat(out):
        """Every output's words on the card (lazy rows gathered there)."""
        return upload_batch([c.data for o in out for c in (o if isinstance(o, list) else [o])],
                            sk.device)

    got = flat(run(sk, few))
    t0 = time.perf_counter()
    with plain_kernels(kernels, server):
        want = flat(run(sk, few))
    torch.cuda.synchronize()
    line["plain_seconds"] = time.perf_counter() - t0
    line[f"vs_plain_b{PLAIN_BATCH}_max_abs_err"] = max_abs_err(got, want)
    return line


def atomic_patterns_phase(kernels, shortint_mod, ck, sk, mck, msk, seed: int) -> dict:
    """Phase 25: the remaining shortint atomic patterns through
    ServerKey.apply_lookup_table_batch and apply_many_lookup_table_batch at
    full width, each set with its keygen seconds, ROUNDS rounds at B = BATCH
    (many-LUT: two functions a call) and PLAIN_BATCH inputs against the
    plain path; the KS32 key's bytes against the 64-bit key's; the drift
    choice on the card against the plain choice on the host."""
    import dataclasses

    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import server, torus
    from tfhe_tpu_torch.shortint import params as sp

    def lut_round(s_key, cts):
        return s_key.apply_lookup_table_batch(
            cts, s_key.generate_lookup_table(lambda x: (3 * x + 1) % 16))

    def lut_want(c_key, out, v):
        return c_key.decrypt_raw(out) != (3 * v + 1) % 16

    def many_round(s_key, cts):
        return s_key.apply_many_lookup_table_batch(
            cts, s_key.generate_many_lookup_table(list(MANY_FNS)))

    def many_want(c_key, outs, v):
        return sum(c_key.decrypt(o) != f(v) for o, f in zip(outs, MANY_FNS))

    lines, errs, keys = {}, {}, {}
    for tag, name, decrypts in ATOMIC_SETS:
        q = getattr(sp, name)
        t0 = time.perf_counter()
        a_ck = shortint_mod.ClientKey(q, seed=seed)
        a_sk = shortint_mod.ServerKey(a_ck, seed=seed + 1, device="cuda")
        torch.cuda.synchronize()
        keygen_s = time.perf_counter() - t0
        keys[tag] = (a_ck, a_sk)
        line = {"params": name, "n": q.lwe_dimension, "N": q.polynomial_size,
                "ks_base_log": q.ks_base_log, "ks_level": q.ks_level,
                "keygen_seconds": keygen_s, "v7_mode": a_sk.trunc_acc,
                **pattern_rounds(kernels, a_ck, a_sk, seed + 2, lut_round, lut_want, decrypts)}
        must, never = ATOMIC_MUST["ks_pbs" if tag.startswith("ks_pbs") else tag]
        check_launches(f"the {tag} round", line, must, never)
        if tag.startswith(("ks32", "ks_pbs")) and not a_sk.trunc_acc:
            raise RuntimeError(f"{name} did not take v7 mode on the card")
        if tag == "ks32":
            line["ksk_device_bytes"] = {
                "words": a_sk.ksk.numel() * 8, "limbs_4": a_sk.ks_key.limbs.numel(),
                "v1_4_2_2_limbs_8": sk.ks_key.limbs.numel(),
                "v1_4_2_2_words": sk.ksk.numel() * 8}
            # many-LUT on the KS32 key (its plain path is the classic key's
            # below but for K1-32, held against plain in the round above)
            line["many_lut"] = pattern_rounds(kernels, a_ck, a_sk, seed + 3, many_round,
                                              many_want, False, plain=False)
            check_launches("the KS32 many-LUT call", line["many_lut"],
                           *ATOMIC_MUST["many_ks32"])
        lines[tag] = line
        errs[f"atomic_{tag}_b{PLAIN_BATCH}"] = line[f"vs_plain_b{PLAIN_BATCH}_max_abs_err"]
    # many-LUT on phase 3's classic key (K2's lazy exact kernel on the exact
    # key) and on phase 8's multi-bit key (K3 exact)
    for tag, c_key, s_key in (("many_classic", ck, sk), ("many_multibit", mck, msk)):
        s_key.exact_bsk_ntt()
        line = pattern_rounds(kernels, c_key, s_key, seed + 4, many_round, many_want, True)
        check_launches(tag, line, *ATOMIC_MUST[tag])
        lines[tag] = line
        errs[f"atomic_{tag}_b{PLAIN_BATCH}"] = line[f"vs_plain_b{PLAIN_BATCH}_max_abs_err"]
    # drift on the TEST set (no tfhe_tpu set uses it): the zeros drawn after
    # the BSK, rounds, and the choice on the card against the host's
    q = dataclasses.replace(sp.TEST_PARAM_MESSAGE_2_CARRY_2, drift_zeros_count=DRIFT_ZEROS,
                            ms_noise_reduction=sp.MsNoiseReduction.DRIFT)
    t0 = time.perf_counter()
    d_ck = shortint_mod.ClientKey(q, seed=seed + 5)
    d_sk = shortint_mod.ServerKey(d_ck, seed=seed + 6, device="cuda")
    torch.cuda.synchronize()
    line = {"params": "TEST_PARAM_MESSAGE_2_CARRY_2 with DRIFT, 16 zeros",
            "keygen_seconds": time.perf_counter() - t0,
            **pattern_rounds(kernels, d_ck, d_sk, seed + 7, lut_round, lut_want, True)}
    check_launches("the drift round", line, *ATOMIC_MUST["drift"])
    errs[f"atomic_drift_b{PLAIN_BATCH}"] = line[f"vs_plain_b{PLAIN_BATCH}_max_abs_err"]
    rows = torus.from_u64(np.stack([np.asarray(d_ck.encrypt(int(v)).data) for v in
                                    np.random.default_rng(seed).integers(0, 4, BATCH)]),
                          "cuda")
    ks = server.keyswitch(rows, d_sk.ksk, q.ks_base_log, q.ks_level)
    args = (q.polynomial_size.bit_length(), q.drift_r_sigma, q.drift_ms_bound,
            q.drift_input_variance * (2.0 ** 64) ** 2)
    t0 = time.perf_counter()
    on_card = server.drift_ms_improve(ks, d_sk.drift_zeros, *args)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    on_host = server.drift_ms_improve(ks.cpu(), d_sk.drift_zeros.cpu(), *args)
    errs[f"atomic_drift_choice_b{BATCH}"] = max_abs_err(on_card.cpu(), on_host)
    line["choice"] = {"batch": BATCH, "card_seconds": card_s,
                      "rows_moved": int((on_card.cpu() != ks.cpu()).any(dim=1).sum()),
                      "max_abs_err_vs_host": errs[f"atomic_drift_choice_b{BATCH}"]}
    lines["drift"] = line
    wrong = sum(v["wrong"] + v.get("many_lut", {}).get("wrong", 0) for v in lines.values())
    return {"line": {**lines, "wrong": wrong}, "errs": errs, "keys": keys, "wrong": wrong}


def wire_phase(kernels, th, seed: int) -> dict:
    """Phase 26: a client -> server -> client round trip through the wire
    format (utils/serialization.py, tfhe_tpu's), at DEFAULT_PARAMS with
    FheUint64: the client (host) makes its keys and a seeded server key,
    encrypts two FheUint64s and serializes all; the server deserializes the
    key, decompresses it onto the card (v7 mode), adds, stores the sum
    modulus-switched on the wire and reads it back (one decompression) and
    serializes the result; the client deserializes and decrypts it.  Each
    step's seconds and payload bytes."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import integer as ti
    from tfhe_tpu_torch.shortint.compressed_key import CompressedServerKey
    from tfhe_tpu_torch.shortint.server_key import ROUND_BITS, _v7_family
    from tfhe_tpu_torch.utils import serialization as ser

    steps, sizes = {}, {}

    def step(name, fn, device=False):
        if device:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device:
            torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        return out

    mod = 1 << 64
    x, y = (int(v) for v in np.random.default_rng(seed).integers(0, mod, 2, dtype=np.uint64))
    # client (host)
    ck = step("client_keygen", lambda: th.ClientKey(th.ConfigBuilder().build(), seed))
    p = ck.integer_key.params
    csk = step("client_seeded_server_key",
               lambda: CompressedServerKey(ck.integer_key.key, seed + 1))
    key_bytes = step("client_serialize_key", lambda: [ser.serialize(csk.seeded_ksk),
                                                        ser.serialize(csk.seeded_bsk)])
    ct_bytes = step("client_encrypt_serialize", lambda: [
        ser.serialize(th.FheUint64.encrypt(v, ck).inner) for v in (x, y)])
    sizes.update(key=[len(b) for b in key_bytes], inputs=[len(b) for b in ct_bytes])
    # server (card)
    floor = ROUND_BITS if _v7_family(p) else 0

    def server_key():
        ksk, bsk = (ser.deserialize(b) for b in key_bytes)
        return ti.ServerKey.from_shortint_key(CompressedServerKey.from_raw_parts(
            p, ksk.seed, ksk.bodies, bsk.seed, bsk.bodies, floor).decompress(device="cuda"))

    sk = step("server_key_decompress", server_key, device=True)
    if not sk.key.trunc_acc or sk.key._bsk_floored != ROUND_BITS:
        raise RuntimeError("the key read from the wire did not take v7 mode on the card")
    a, b = step("server_deserialize_inputs", lambda: [ser.deserialize(c) for c in ct_bytes])
    launches = {}
    total, launches["add"], steps["server_add"], _ = counted(
        kernels, lambda: sk.add_parallelized(a, b))
    stored, launches["switch_modulus_and_compress"], steps["server_store"], _ = counted(
        kernels, lambda: ser.serialize(sk.switch_modulus_and_compress(total)))
    out, launches["decompress"], steps["server_read_back"], _ = counted(
        kernels, lambda: ser.serialize(sk.decompress(ser.deserialize(stored))))
    sizes.update(stored=len(stored), result=len(out))
    # client
    got = step("client_deserialize_decrypt",
               lambda: ck.integer_key.decrypt_radix(ser.deserialize(out)))
    wrong = int(got != (x + y) % mod)
    line = {"params": "DEFAULT_PARAMS", "type": "FheUint64", "seconds": steps,
            "payload_bytes": sizes, "launches": launches, "bsk_floored": sk.key._bsk_floored,
            "v7_mode": sk.key.trunc_acc, "wrong": wrong}
    check_launches("the wire add", {"launches": launches["add"]}, V7_MUST, never=V7_NEVER)
    if (launches["switch_modulus_and_compress"]["keyswitch"] != len(total.blocks)
            or launches["decompress"]["blind_rotate_exact_lazy"] != 1):
        raise RuntimeError(f"the wire's storage did not run K1 a block and K2's lazy "
                           f"exact kernel once: {launches}")
    return {"line": line, "wrong": wrong}


def unsplit_keyswitch32(kernels, ct, ksk32, base_log: int, levels: int):
    """K1-32's tensor-core kernel through its C entry with the contraction
    whole (one slice a block: the grid before the split)."""
    import torch

    limbs = ksk32.limbs
    b, m_out = ct.shape[0], ksk32.words.shape[2]
    out = torch.empty((b, m_out), dtype=torch.int64, device=ct.device)
    digits = torch.empty((-(-b // kernels.IM_BM) * kernels.IM_BM, limbs.shape[0],
                          limbs.shape[2]), dtype=torch.int8, device=ct.device)
    err = kernels.load()["keyswitch"].tfhe_torch_keyswitch32_imma(
        out.data_ptr(), ct.data_ptr(), limbs.data_ptr(), digits.data_ptr(), b,
        ct.shape[1] - 1, levels, m_out, base_log, limbs.shape[0], limbs.shape[1], 1,
        kernels._stream(ct))
    if err:
        raise RuntimeError(f"K1-32's tensor-core kernel failed: cudaError {err}")
    return out


def ks32_vs_plain(kernels, server, torus, atomic_run, rng, errs: dict) -> dict:
    """K1-32 at both KS32 shapes (V1_4: n_in = 2048, l = 5; TEST: n_in = 512,
    l = 3; base 2^4) on B = 512 encryptions under phase 25's keys, its
    generic kernel and the int8 yardstick there, and at B = 1 and 513 on
    random words, against the plain keyswitch32 (into errs).  Returns its
    figures at each shape."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    k132 = {}
    for tag in ("ks32", "test_ks32"):
        a_ck, a_sk = atomic_run["keys"][tag]
        q = a_sk.params
        if not isinstance(a_sk.ks_key, kernels.KeyswitchKeyLimbs) or a_sk.ks_key.word_bytes != 4:
            raise RuntimeError(f"the {tag} key holds no 4-limb byte layout for K1-32")
        ct = torus.from_u64(np.stack([np.asarray(a_ck.encrypt(int(v)).data) for v in
                                      rng.integers(0, 4, BATCH)]), dev)
        kargs = (ct, a_sk.ks_key, q.ks_base_log, q.ks_level)
        pargs = (ct, a_sk.ksk, q.ks_base_log, q.ks_level)
        imma_before = kernels.keyswitch32.imma_launches
        got = kernels.keyswitch32(*kargs)
        if kernels.keyswitch32.imma_launches != imma_before + 1:
            raise RuntimeError(f"K1-32 at the {tag} shape did not take its tensor-core kernel")
        want = server.keyswitch32(*pargs)
        errs[f"ks32_{tag}_b{BATCH}"] = max_abs_err(got, want)
        errs[f"ks32_{tag}_generic_kernel_b{BATCH}"] = max_abs_err(
            generic_keyswitch32(kernels, *pargs), want)
        errs[f"ks32_{tag}_int_mm_b{BATCH}"] = max_abs_err(int_mm_keyswitch32(*pargs), want)
        for b in (1, BATCH + 1):
            rct = torus.from_u64(rng.integers(0, 1 << 64, (b, ct.shape[1]),
                                              dtype=np.uint64), dev)
            errs[f"ks32_{tag}_b{b}"] = max_abs_err(
                kernels.keyswitch32(rct, a_sk.ks_key, q.ks_base_log, q.ks_level),
                server.keyswitch32(rct, a_sk.ksk, q.ks_base_log, q.ks_level))
        bound = k1_bound(ct, a_sk.ksk, got, q.ks_base_log, word_bytes=4)
        limbs = a_sk.ks_key.limbs
        splits = kernels.keyswitch_splits(
            limbs.shape[1] // kernels.IM_BN * -(-BATCH // kernels.IM_BM), limbs.shape[0],
            torch.cuda.get_device_properties(dev).multi_processor_count)
        errs[f"ks32_{tag}_unsplit_b{BATCH}"] = max_abs_err(
            unsplit_keyswitch32(kernels, *kargs), want)
        k132[tag] = {"ms": cuda_ms(lambda: kernels.keyswitch32(*kargs), 10),
                     "splits": splits,
                     "unsplit_ms": cuda_ms(lambda: unsplit_keyswitch32(kernels, *kargs), 10),
                     "plain_ms": cuda_ms(lambda: server.keyswitch32(*pargs), 3),
                     "generic_kernel_ms": cuda_ms(lambda: generic_keyswitch32(kernels, *pargs),
                                                  10),
                     "library_ms": cuda_ms(lambda: int_mm_keyswitch32(*pargs), 10),
                     "bound_ms": bound["ms"], "bound_by": bound["by"],
                     "bound_bytes_ms": bound["bytes_ms"],
                     "key_limb_bytes": a_sk.ks_key.limbs.numel(),
                     "shape": [BATCH] + list(a_sk.ksk.shape)}
    return k132


def atomic_table_entries(table: list, atomic_run, wire_run, errs: dict, k132: dict,
                         ptxas_kernels: dict) -> None:
    """K1-32's entry of the kernel table, and the launches of phases 25-26
    added to the entries of K1, K2 (v7 and exact) and K3 exact, by path."""
    at_lines = atomic_run["line"]
    at_runs = {tag: at_lines[tag]["launches"] for tag in at_lines if tag != "wrong"}
    at_runs["ks32_many_lut"] = at_lines["ks32"]["many_lut"]["launches"]
    wire_l = wire_run["line"]["launches"]
    at_runs.update({f"wire_{k}": v for k, v in wire_l.items()})

    def by_path(counter: str, tags=None) -> dict:
        return {f"atomic_{t}" if not t.startswith("wire") else t: c.get(counter, 0)
                for t, c in at_runs.items()
                if c.get(counter, 0) and (tags is None or t in tags)}

    ks32_regs = ptxas_of(ptxas_kernels, "keyswitch32_imma_kernel")
    table.append({
        "name": "keyswitch32", "route": "cuda",
        "source": "tfhe_tpu_torch/csrc/keyswitch.cu",
        "replaces": "tfhe_tpu/ops/server.py:110",
        "kernel": "keyswitch32_imma_kernel (int8 tensor cores, 4 byte limbs a u32 key word; "
                  "keyswitch32_kernel elsewhere)",
        "launches": sum(by_path("keyswitch32").values()),
        "launches_by_path": by_path("keyswitch32"),
        "tensor_core_launches_by_path": by_path("keyswitch32_imma"),
        "max_abs_err": max(v for k, v in errs.items() if k.startswith("ks32")),
        **k132["ks32"],
        "test_shape": k132["test_ks32"],
        "library_call": "4 int8 torch._int_mm GEMMs of the digits by signed byte limbs of "
                        "the u32 key, recombined mod 2^32",
        "registers": ks32_regs.get("registers"),
        "spill_store_bytes": ks32_regs.get("spill_store_bytes"),
        "generic_kernel_registers": ptxas_of(ptxas_kernels, "keyswitch32_kernel").get(
            "registers")})
    by_name = {entry["name"]: entry for entry in table}
    v7_tags = ("ks32", "ks_pbs_2m64", "ks_pbs_2m40", "ks_pbs_gaussian", "wire_add")
    lazy_tags = ("pbs_ks", "many_classic", "ks32_many_lut", "wire_decompress")
    for name, counter, tags, key in (
            ("keyswitch", "keyswitch", None, "launches_by_path"),
            ("keyswitch", "keyswitch_imma", None, "tensor_core_launches_by_path"),
            ("blind_rotate", "blind_rotate", v7_tags, "launches_by_path"),
            ("blind_rotate_exact", "blind_rotate_exact_lazy", lazy_tags, "launches_by_path"),
            ("blind_rotate_cluster_small", "blind_rotate_cluster",
             ("test_ks32", "test_pbs_ks", "drift"), "launches_by_path"),
            ("blind_rotate_multibit_exact", "blind_rotate_multibit", ("many_multibit",),
             "launches_by_path")):
        extra = by_path(counter, tags)
        by_name[name].setdefault(key, {}).update(extra)
        if key == "launches_by_path":
            by_name[name]["launches"] += sum(extra.values())


# ---------------------------------------------------------------------------
# Phases 27-30: squashed-noise compression (K6), WoPBS (K1 at the PFPKS
# shape, K2's CMux and step entries), AES over WoPBS, the test vectors
# ---------------------------------------------------------------------------

SQC_LISTS = 4                 # 512 squashed results as 4 lists of 128
WOPBS_TREE_BITS = 10          # vertical packing with one level of CMux tree (N = 512)
AES_SBOX_BYTES = bytes([0x53, 0x00, 0xFF, 0x1B])
K6_COUNTS = (1, 16, 128)
# mask words whose base-2^61 digit is +2^60 and -2^60 (the tie rounds down
# to -2^60 where the rounding bit is set)
K6_DIGIT_PLUS = 1 << 127
K6_DIGIT_MINUS = (1 << 127) - (1 << 66)
TEST_VECTOR_DIRS = ("build/test_vectors/cuda", "build/test_vectors/cpu")


# K6's limb pairs: a signed digit of up to 63 bits is 8 byte limbs, a u128
# key word 16, and mod 2^128 only the pairs a + b <= 15 count
K6_LIMB_PAIRS = sum(16 - a for a in range(8))      # 100


def k6_bound(key, counts) -> dict:
    """Least time for K6 on lists of the given counts: the key, the input
    LWEs and the output GLWEs moved once (u128 words), against the cheaper
    way to do its multiply-adds of a signed 61-bit digit by a u128 key word
    mod 2^128: on the CUDA cores' 32-bit integer rate (two 32-bit limbs of
    the digit times four of the word: the 7 limb products below 2^128, 5
    of them both halves and 2 the low half only, 12 multiplies), or as
    K6_LIMB_PAIRS int8 limb products on the tensor cores (as k1_bound counts
    K1).  Counted for the slots these inputs hold (counts), not the N a GLWE
    could."""
    n_in, levels, k1, n_poly, _ = key.shape
    macs = sum(counts) * n_in * levels * k1 * n_poly
    t_int32 = 12 * macs / INT32_MUL_PER_S
    t_int8 = 2 * K6_LIMB_PAIRS * macs / INT8_TC_OPS_PER_S
    t_ops = min(t_int32, t_int8)
    nbytes = 8 * key.numel() + 16 * (sum(counts) * (n_in + 1) + len(counts) * k1 * n_poly)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"ms": max(t_bytes, t_ops) * 1e3, "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "ops_int32_ms": t_int32 * 1e3,
            "ops_limbs_int8_ms": t_int8 * 1e3, "multiply_adds": macs}


def cmux_bound(ct0, levels: int, base_log: int) -> dict:
    """Least time for K2's CMux entry: one step of the exact rotation's
    products as k2_bound counts them (four primes), against the GGSW (NTT
    domain, u32 residues), ct0, ct1 and the output moved once."""
    import torch

    b, k1, n_poly = ct0.shape
    ops = k2_bound(torch.zeros((b, 1), dtype=torch.int32), ct0, levels, base_log,
                   EXACT_PRIMES)
    t_ops = min(ops["ntt_ms"], ops["four_step_ms"])
    t_bytes = ((4 * levels * k1 * k1 * EXACT_PRIMES * n_poly + 3 * 8 * ct0.numel())
               / HBM_BYTES_PER_S * 1e3)
    return {"ms": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ntt_ms": ops["ntt_ms"], "four_step_ms": ops["four_step_ms"]}


def squashed_lwes(cts, device):
    """(1, len(cts), n+1, 2) int64: the squashed ciphertexts' (lo, hi) words
    in K6's input layout."""
    import torch

    return torch.stack([torch.stack([c.lo for c in cts]), torch.stack([c.hi for c in cts])],
                       dim=-1)[None].to(device)


def squash_compress_phase(kernels, ns, sq_priv, nsk, sk, squashed, want, u64_add, u64_want: int,
                          seed: int):
    """Phase 27: squashed-noise compression at the production sets: V1_4
    compression keygen over phase 11's squashing key (k_out = 6, N_out =
    1024, 128 slots a GLWE; the key's standard-domain u128 words on the
    card); the first 128 of phase 12's squashed outputs compressed (one K6
    launch) and decrypted with decrypt_list on the host; phase 14's FheUint64
    sum squashed (K1, K5 at B = 32) and its 32 blocks compressed; all 512
    squashed outputs as 4 lists in one K6 launch, cold and warm (the same
    words); stored bytes against the squashed lists' bytes."""
    import numpy as np
    import torch

    comp = ns.V1_4_NOISE_SQUASHING_COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    t0 = time.perf_counter()
    cpriv = ns.NoiseSquashingCompressionPrivateKey(comp, seed=seed)
    ckey = ns.NoiseSquashingCompressionKey(sq_priv, cpriv, seed=seed + 1, device="cuda")
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    per = comp.lwe_per_glwe
    lists = [squashed[g * per:(g + 1) * per] for g in range(SQC_LISTS)]
    one, one_launches, one_s, _ = counted(kernels, lambda: ckey.compress(lists[0]))
    wrong = sum(a != b for a, b in zip(cpriv.decrypt_list(one), want[:per]))
    blocks = u64_add.blocks
    sq_blocks = nsk.squash_ciphertext_noise_batch(blocks, sk)
    block_want = [(u64_want >> (2 * i)) & 3 for i in range(len(blocks))]
    packed64, u64_launches, u64_s, _ = counted(kernels, lambda: ckey.compress(sq_blocks))
    wrong += sum(a != b for a, b in zip(cpriv.decrypt_list(packed64), block_want))
    runs = [counted(kernels, lambda: ckey.compress_batch(lists)) for _ in range(2)]
    batch = runs[0][0]
    for g, packed in enumerate(batch):
        wrong += sum(a != b for a, b in zip(cpriv.decrypt_list(packed), want[g * per:(g + 1) * per]))
    same = all(np.array_equal(a.glwe_lo, b.glwe_lo) and np.array_equal(a.glwe_hi, b.glwe_hi)
               for a, b in zip(runs[0][0], runs[1][0]))
    same &= (np.array_equal(one.glwe_lo, batch[0].glwe_lo)
             and np.array_equal(one.glwe_hi, batch[0].glwe_hi))
    for tag, got, n in (("one list", one_launches, 1), ("FheUint64", u64_launches, 1),
                        ("four lists", runs[0][1], 1), ("four lists, warm", runs[1][1], 1)):
        if got != only(kernels, packing_keyswitch128=n):
            raise RuntimeError(f"compress ({tag}) did not run K6 once: {got}")
    stored = sum(p.glwe_lo.nbytes + p.glwe_hi.nbytes for p in batch)
    n_big = sq_priv.params.glwe_dimension * sq_priv.params.polynomial_size
    line = {"params": "V1_4_NOISE_SQUASHING_COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
            "n_in": n_big, "k_out": comp.packing_ks_glwe_dimension,
            "N_out": comp.packing_ks_polynomial_size, "lwe_per_glwe": per,
            "base_log": comp.packing_ks_base_log, "levels": comp.packing_ks_level,
            "keygen_seconds": keygen_s, "key_device_bytes": ckey.device_bytes,
            "one_list": {"slots": per, "seconds": one_s, "launches": one_launches},
            "fheuint64": {"blocks": len(blocks), "seconds": u64_s, "launches": u64_launches},
            "four_lists": {"results": SQC_LISTS * per, "cold_seconds": runs[0][2],
                           "warm_seconds": runs[1][2], "cold_host_seconds": runs[0][3],
                           "warm_host_seconds": runs[1][3], "launches": runs[0][1],
                           "warm_launches": runs[1][1], "same_words": same},
            "stored_bytes": stored,
            "squashed_bytes": SQC_LISTS * per * (n_big + 1) * 16,
            "outputs_checked": SQC_LISTS * per + per + len(blocks), "wrong": wrong + (not same)}
    return {"line": line, "wrong": line["wrong"], "ckey": ckey, "lists": lists,
            "sq_blocks": sq_blocks}


def generic_cmux(kernels, ct0, ct1, ggsw, dp, base_log: int, levels: int):
    """K2's CMux entry's first design, the generic exact kernel's external
    product (csrc/blind_rotate.cu cmux_kernel), through its C entry at any
    shape it takes: out = ct0 + GGSW (x) (ct1 - ct0), a new tensor."""
    import torch

    out = torch.empty_like(ct0)
    b, k1, n_poly = ct0.shape
    err = kernels.load()["blind_rotate"].tfhe_torch_cmux(
        out.data_ptr(), ct0.data_ptr(), ct1.data_ptr(), ggsw.data_ptr(), dp.psi32.data_ptr(),
        dp.psi_inv32.data_ptr(), dp.kernel_consts.data_ptr(), b, k1, n_poly.bit_length() - 1,
        levels, dp.num_primes, base_log, kernels._stream(ct0))
    if err:
        raise RuntimeError(f"K2's generic CMux kernel failed: cudaError {err}")
    return out


def cmux_route_figures(kernels, server, ct0, ct1, ggsw, dp, base_log: int, levels: int,
                       errs: dict, tag: str) -> dict:
    """K2's CMux entry (kernels.cmux) on one input: one launch checked to
    run on its route's kernel, its words (errs[tag]) and the generic
    kernel's through its C entry (errs[tag + "_generic"]) against
    server.cmux; the device's ms a launch from CUDA graphs, the new route's
    and the generic kernel's in turns (new, generic, generic, new); the
    wrapper's ms over 10 event-timed launches and the host's ms to enqueue
    one; the plain version's ms, cmux_bound and the share of it; the
    route's block figures."""
    b, k1, n_poly = ct0.shape
    args = (dp, base_log, levels)
    route = kernels.cmux_route(k1, n_poly, levels, base_log)
    want = server.cmux(ct0, ct1, ggsw, *args)
    counts = ("launches", "small_launches", "cluster_launches")
    before = [getattr(kernels.cmux, c) for c in counts]
    got = kernels.cmux(ct0, ct1, ggsw, *args)
    made = [getattr(kernels.cmux, c) - n for c, n in zip(counts, before)]
    if made != [1, route == "small", route == "cluster"]:
        raise RuntimeError(f"K2's CMux entry ({tag}) did not make one {route} launch: {made}")
    errs[tag] = max_abs_err(got, want)
    errs[f"{tag}_generic"] = max_abs_err(generic_cmux(kernels, ct0, ct1, ggsw, *args), want)
    runs = {"new": lambda: kernels.cmux(ct0, ct1, ggsw, *args),
            "generic": lambda: generic_cmux(kernels, ct0, ct1, ggsw, *args)}
    times = {name: [] for name in runs}
    for name in list(runs) + list(reversed(runs)):
        times[name].append(graph_ms(runs[name]))
    wrapper_ms, host_ms = launch_ms(runs["new"], 10)
    bound = cmux_bound(ct0, levels, base_log)
    fig = {"route": route, "ms": min(times["new"]), "graph_ms_in_turns": times["new"],
           "generic_ms": min(times["generic"]), "generic_graph_ms_in_turns": times["generic"],
           "wrapper_ms": wrapper_ms, "wrapper_host_ms": host_ms,
           "plain_ms": cuda_ms(lambda: server.cmux(ct0, ct1, ggsw, *args), 3),
           "bound": bound, "share_of_bound": bound["ms"] / min(times["new"]),
           "shape": [b, k1, n_poly, levels, base_log]}
    if route != "generic":
        fig.update(kernels.cmux_figures(k1, n_poly, levels))
    return fig


def wopbs_phase(kernels, shortint_mod, wopbs, seed: int) -> dict:
    """Phase 28: WoPBS at TEST_PARAM_MESSAGE_2_CARRY_2 and TEST_WOPBS_PARAM
    (the only WoPBS sets either package has) on the card: keygen;
    extract_bits (one PBS round: K1, K2's cluster kernel at N = 512);
    apply_wopbs with the identity and a non-monotone LUT over all 16 inputs
    (each: the bits' PBS, the circuit bootstrap's PBS round and one K1
    launch at the PFPKS shape, the four low-bit rotations in one launch of
    K2's CMux chain); a WOPBS_TREE_BITS-bit vertical packing (one K2 CMux
    launch for the tree, on its small route, the small-N cluster kernel's
    CMux mode; its nine low bits in one chain launch).  Every output
    decrypted."""
    import numpy as np
    import torch

    p = shortint_mod.TEST_PARAM_MESSAGE_2_CARRY_2
    t0 = time.perf_counter()
    ck = shortint_mod.ClientKey(p, seed=seed)
    sk = shortint_mod.ServerKey(ck, seed=seed + 1, device="cuda")
    wk = wopbs.WopbsKey(ck, sk, wopbs.TEST_WOPBS_PARAM, seed=seed + 2)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    value = 0b1011
    bits, bit_launches, bit_s, _ = counted(
        kernels, lambda: wk.extract_bits(ck.encrypt_without_padding_value(value), 4))
    wrong = sum((ck.decrypt_raw(b) & 1) != ((value >> (3 - i)) & 1) for i, b in enumerate(bits))
    luts = {"identity": lambda x: x, "nonmonotone": lambda x: (x * x + 3) % 16}
    lines = {}
    for name, f in luts.items():
        cts = [ck.encrypt_without_padding_value(v) for v in range(16)]
        outs, launches, secs, _ = counted(kernels, lambda: [wk.apply_wopbs(c, f, 4) for c in cts])
        bad = sum(ck.decrypt_raw(o) != f(v) for v, o in enumerate(outs))
        wrong += bad
        lines[name] = {"inputs": 16, "seconds": secs, "launches": launches,
                       "pfpks_launches": launches["keyswitch_limbs"],
                       "generic_keyswitch_launches": generic_keyswitches(launches),
                       "wrong": bad}
        if launches != only(kernels, keyswitch=48, keyswitch_imma=32, keyswitch_limbs=16,
                            blind_rotate=32, blind_rotate_cluster=32, cmux_chain=16):
            raise RuntimeError(f"apply_wopbs ({name}) did not run K1 (16 at the PFPKS shape, "
                               f"its limb-row kernel), K2's cluster kernel and its CMux chain "
                               f"as expected: {launches}")
    rng = np.random.default_rng(seed)
    v = int(rng.integers(0, 1 << WOPBS_TREE_BITS))
    f = lambda x: (x ^ (x >> 3)) % 16  # noqa: E731
    bit_cts = [ck.encrypt_without_padding_value((v >> j) & 1)
               for j in range(WOPBS_TREE_BITS - 1, -1, -1)]
    table = [f(x) for x in range(1 << WOPBS_TREE_BITS)]
    tree_out, tree_launches, tree_s, _ = counted(
        kernels, lambda: wk.vertical_packing(wk.circuit_bootstrap_bits(bit_cts), table, p.delta))
    wrong += ck.decrypt_raw(tree_out) != f(v)
    if tree_launches != only(kernels, keyswitch=2, keyswitch_imma=1, keyswitch_limbs=1,
                             blind_rotate=1, blind_rotate_cluster=1, cmux=1, cmux_small=1,
                             cmux_chain=1):
        raise RuntimeError(f"the {WOPBS_TREE_BITS}-bit vertical packing did not run one CMux "
                           f"launch (on the small-N cluster kernel) and one CMux-chain "
                           f"launch: {tree_launches}")
    # the PFPKS inputs of one circuit bootstrap, for the kernel comparisons
    outs = sk.apply_lookup_table_batch(
        [c for _ in range(wk.params.cbs_level) for c in bit_cts],
        [wk._bit_lut(1 << (64 - wk.params.cbs_log_shift(lev)))
         for lev in range(wk.params.cbs_level) for _ in bit_cts])
    from tfhe_tpu_torch.shortint.server_key import upload_batch

    lwes = upload_batch([o.data for o in outs], sk.device)
    ggsw = wk.circuit_bootstrap_bit(bit_cts[0])
    line = {"params": "TEST_PARAM_MESSAGE_2_CARRY_2 + TEST_WOPBS_PARAM",
            "keygen_seconds": keygen_s, "pfpks_key_device_bytes": wk.pfpksk.numel() * 8,
            "pfpks_shape": list(wk.pfpksk.shape),
            "pfpks_kernel": kernels.keyswitch_route(
                wk.pfpksk.shape[0], wk.params.pfks_level, wk.params.pfks_base_log),
            "extract_bits": {"seconds": bit_s, "launches": bit_launches},
            "apply_wopbs": lines,
            "vertical_packing": {"bits": WOPBS_TREE_BITS, "seconds": tree_s,
                                 "launches": tree_launches,
                                 "cmux_route": kernels.cmux_route(
                                     wk.k + 1, wk.n_poly, wk.params.cbs_level,
                                     wk.params.cbs_base_log)},
            "outputs_checked": 4 + 32 + 1, "wrong": int(wrong)}
    return {"line": line, "wrong": int(wrong), "wk": wk, "sk": sk, "ck": ck, "ggsw": ggsw,
            "tree_bits": bit_cts, "tree_table": table,
            "pfpks_lwes": torch.cat([lwes, lwes.new_zeros((lwes.shape[0], 1))], dim=1)}


def aes_phase(kernels, shortint_mod, integer, wopbs, aes, seed: int) -> dict:
    """Phase 29: AES over WoPBS at TEST_PARAM_MESSAGE_2_CARRY_2 (tfhe_tpu's
    only WoPBS set): the S-box of 4 encrypted bytes (one bits' PBS round,
    one circuit bootstrap, a vertical packing a byte and block, all of
    their low bits in one launch of K2's CMux chain, one refresh round),
    then one AES-128 round on an encrypted state with injected encrypted
    round keys against the cleartext model (tests/test_aes.py:39-75): a
    chain launch for its S-box, one for x2 and one for x3."""
    import torch

    p = shortint_mod.TEST_PARAM_MESSAGE_2_CARRY_2
    t0 = time.perf_counter()
    ck = integer.ClientKey(p, seed=seed)
    sk = integer.ServerKey(ck, seed=seed + 1, device="cuda")
    wk = wopbs.WopbsKey(ck.key, sk.key, wopbs.TEST_WOPBS_PARAM, seed=seed + 2)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    box = aes.FheAes128.__new__(aes.FheAes128)
    box.sk, box.wk = sk, wk
    enc = [ck.encrypt_radix(b, 4) for b in AES_SBOX_BYTES]
    outs, sbox_launches, sbox_s, _ = counted(kernels, lambda: box._sbox_bytes(enc))
    wrong = sum(ck.decrypt_radix(o) != aes.SBOX[b] for o, b in zip(outs, AES_SBOX_BYTES))
    key = bytes(range(16))
    block = bytes.fromhex("00112233445566778899aabbccddeeff")
    rks = aes.key_expansion(key)
    box.round_keys = [[ck.encrypt_radix(b, 4) for b in rk] for rk in rks[:2]]
    out, round_launches, round_s, _ = counted(kernels, lambda: box.encrypt_block(list(block),
                                                                                rounds=1))
    s = [b ^ k for b, k in zip(block, rks[0])]
    s = [aes.SBOX[b] for b in s]
    sr = aes._shift_rows_idx()
    s = [s[sr[i]] for i in range(16)]
    s = sum((aes._mix_single_column(s[4 * c:4 * c + 4]) for c in range(4)), [])
    s = [b ^ k for b, k in zip(s, rks[1])]
    got = bytes(ck.decrypt_radix(b) for b in out)
    wrong += sum(a != b for a, b in zip(got, s))
    line = {"params": "TEST_PARAM_MESSAGE_2_CARRY_2 + TEST_WOPBS_PARAM", "keygen_seconds": keygen_s,
            "sbox": {"bytes": len(AES_SBOX_BYTES), "seconds": sbox_s, "launches": sbox_launches},
            "aes128_round": {"rounds": 1, "seconds": round_s, "launches": round_launches,
                             "output_hex": got.hex(), "want_hex": bytes(s).hex()},
            "outputs_checked": len(AES_SBOX_BYTES) + 16, "wrong": int(wrong)}
    for tag, launches, chains in (("S-box", sbox_launches, 1), ("AES round", round_launches, 3)):
        if not (launches["keyswitch"] and launches["blind_rotate"]
                and launches["keyswitch_limbs"] and not generic_keyswitches(launches)
                and launches["blind_rotate_cluster"] == launches["blind_rotate"]
                and launches["cmux_chain"] == chains and not launches["cmux_step"]):
            raise RuntimeError(f"the {tag} did not run K1 (its PFPKS on the limb-row kernel, "
                               f"no generic keyswitch), K2's cluster kernel and {chains} "
                               f"CMux-chain launches without K2's step entry: {launches}")
    return {"line": line, "wrong": int(wrong)}


def test_vectors_start() -> object:
    """Start the test vectors' emission on the CPU (the plain versions) in a
    process of its own, two torch threads, beside the card's phases; a
    failure of a later phase stops it at exit."""
    import os

    env = dict(os.environ, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tfhe_tpu_torch.apps.test_vectors", TEST_VECTOR_DIRS[1],
         "--device", "cpu"], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def test_vectors_phase(kernels, test_vectors, cpu_proc) -> dict:
    """Phase 30: both test-vector sets (toy_params, valid_params_128)
    emitted on the card (K1, K2's exact rotation: its generic kernel at N =
    256 and the lazy kernel at N = 2048), then compared byte for byte with
    the same emission on the CPU (started at phase 2 in a process of its
    own)."""
    import pathlib

    _, launches, secs, _ = counted(kernels, lambda: test_vectors.main(TEST_VECTOR_DIRS[0],
                                                                      "cuda"))
    t0 = time.perf_counter()
    _, err = cpu_proc.communicate(timeout=900)
    wait_s = time.perf_counter() - t0
    if cpu_proc.returncode:
        raise RuntimeError(f"the CPU emission of the test vectors failed: {err[-2000:]}")
    files, differing = 0, []
    for sub in ("toy_params", "valid_params_128"):
        a_dir = pathlib.Path(TEST_VECTOR_DIRS[0]) / sub
        b_dir = pathlib.Path(TEST_VECTOR_DIRS[1]) / sub
        names = sorted(x.name for x in a_dir.iterdir())
        if names != sorted(x.name for x in b_dir.iterdir()):
            differing.append(f"{sub}: file lists")
        for name in names:
            files += 1
            if (a_dir / name).read_bytes() != (b_dir / name).read_bytes():
                differing.append(f"{sub}/{name}")
    if launches["keyswitch"] != 2 or launches["blind_rotate"] != 4:
        raise RuntimeError(f"the test vectors did not run K1 twice and K2 four times: {launches}")
    return {"line": {"sets": ["toy_params", "valid_params_128"], "seconds": secs,
                     "launches": launches, "cpu_wait_seconds": wait_s, "files": files,
                     "differing": differing, "wrong": len(differing)},
            "wrong": len(differing)}


def slice13_vs_plain(kernels, server, server128, sqc_run, wopbs_run, seed: int,
                     errs: dict) -> dict:
    """K6 (on the key's byte layout) against its plain version (8-prime
    CRT-NTT, on the key's words) on phase 27's V1_4 key and squashed inputs at
    count 1, 16 and 128, and on masks of the extreme digits +-2^60, and at
    the TEST shape on a random key; K1's generic
    kernel at base 2^37 (the toy test vectors' keyswitch); K1 at the PFPKS
    shape on phase 28's circuit-bootstrap LWEs against the plain keyswitch;
    K2's CMux entry (its small route) against server.cmux on one of phase
    28's GGSWs at the tree's B = 1 and at B = 64, in turns with the
    generic kernel it replaced there (cmux_route_figures); phase 28's 10-bit vertical
    packing on the step route (one K2 step launch a low bit, the route of
    GGSW shapes the chain's kernel refuses) against the chain's words.
    Times, bounds."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import ntt

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(shape):
        return torch.randint(-(1 << 62), 1 << 62, shape, generator=gen, device=dev,
                             dtype=torch.int64) * 2 + torch.randint(
            0, 2, shape, generator=gen, device=dev, dtype=torch.int64)

    def k6_err(tag, lwes, kkey, counts, dp8):
        key = kernels.packing_keyswitch128_key_words(kkey)
        keep = (torch.arange(lwes.shape[1], device=dev)[None, :]
                < torch.tensor(counts, device=dev)[:, None])
        lw = lwes * keep[:, :, None, None]
        lo, hi = server128.packing_keyswitch128(lw[..., 0], lw[..., 1], key[..., 0],
                                                key[..., 1], dp8, 61, 1)
        before = kernels.packing_keyswitch128.launches
        got = kernels.packing_keyswitch128(lwes, kkey, counts, 61, 1, dp8)
        if kernels.packing_keyswitch128.launches != before + 1:
            raise RuntimeError(f"K6 did not launch ({tag})")
        errs[f"k6_{tag}"] = int(((got[..., 0] != lo) | (got[..., 1] != hi)).sum())

    def extremes(n_in):
        sel = ((torch.arange(n_in + 1, device=dev)[None, :]
                + torch.arange(16, device=dev)[:, None]) % 3) == 0
        out = torch.empty((1, 16, n_in + 1, 2), dtype=torch.int64, device=dev)
        for w, shift in enumerate((0, 64)):
            plus = int(np.uint64((K6_DIGIT_PLUS >> shift) & (2**64 - 1)).view(np.int64))
            minus = int(np.uint64((K6_DIGIT_MINUS >> shift) & (2**64 - 1)).view(np.int64))
            out[0, :, :, w] = torch.where(sel, torch.tensor(minus, device=dev),
                                          torch.tensor(plus, device=dev))
        return out

    ckey = sqc_run["ckey"]
    kkey, dp8 = ckey.pksk, ckey.dp
    if kkey.dtype != torch.uint8:
        raise RuntimeError("the compression key holds no byte layout of its key for K6")
    key = kernels.packing_keyswitch128_key_words(kkey)
    lwes4 = torch.cat([squashed_lwes(cts, dev) for cts in sqc_run["lists"]])
    for count in K6_COUNTS:
        k6_err(f"v1_4_c{count}", lwes4[:1, :count], kkey, [count], dp8)
    k6_err("v1_4_extreme_digits", extremes(key.shape[0]), kkey, [16], dp8)
    test_kkey = kernels.packing_keyswitch128_key(rnd((512, 1, 3, 256, 2)))
    test_dp = ntt.device_plan(ntt.make_plan(256, 8), "cuda")
    for count in K6_COUNTS:
        k6_err(f"test_c{count}", rnd((2, count, 513, 2)), test_kkey,
               [count, max(1, count // 2)], test_dp)
    k6_err("test_extreme_digits", extremes(512), test_kkey, [16], test_dp)
    counts4 = [lwes4.shape[1]] * lwes4.shape[0]
    k6 = {"ms": cuda_ms(lambda: kernels.packing_keyswitch128(lwes4, kkey, counts4, 61, 1, dp8),
                        5),
          "one_list_ms": cuda_ms(lambda: kernels.packing_keyswitch128(
              lwes4[:1], kkey, counts4[:1], 61, 1, dp8), 5),
          "ms_again": cuda_ms(lambda: kernels.packing_keyswitch128(lwes4, kkey, counts4, 61,
                                                                   1, dp8), 5),
          "plain_ms": cuda_ms(lambda: server128.packing_keyswitch128(
              lwes4[..., 0], lwes4[..., 1], key[..., 0], key[..., 1], dp8, 61, 1), 1),
          "bound": k6_bound(key, counts4), "one_list_bound": k6_bound(key, counts4[:1]),
          "shared_memory_bytes": kernels.packing_keyswitch128_imma_smem(
              key.shape[2], key.shape[3], 1, 61, counts4[0]),
          "key_limbs_device_bytes": kkey.numel(),
          "shape": list(lwes4.shape[:3]) + list(key.shape[2:4])}
    # K1's generic kernel at the test vectors' toy keyswitch (base 2^37, l =
    # 1: its 64-bit-digit instance) on random words
    toy_ct, toy_ksk = rnd((32, 257)), rnd((256, 1, 11))
    errs["k1_generic_base37"] = max_abs_err(kernels.keyswitch(toy_ct, toy_ksk, 37, 1),
                                            server.keyswitch(toy_ct, toy_ksk, 37, 1))
    # K1 at the PFPKS shape: its limb-row kernel on phase 28's circuit
    # bootstrap LWEs at B = 1, 3 and all 40 (each launch on that kernel)
    # against the plain keyswitch, then timed in turns with the generic
    # kernel it replaced there and through its C entry alone
    wk = wopbs_run["wk"]
    lw = wopbs_run["pfpks_lwes"]
    prm = wk.params
    pf_args = (prm.pfks_base_log, prm.pfks_level)
    for b in (1, 3, lw.shape[0]):
        before = kernels.keyswitch.limb_launches
        got = kernels.keyswitch(lw[:b].contiguous(), wk.pfpks_key, *pf_args)
        if kernels.keyswitch.limb_launches != before + 1:
            raise RuntimeError(f"K1 at the PFPKS shape, B = {b}, did not run its limb-row "
                               f"kernel")
        errs[f"pfpks_k1_b{b}"] = max_abs_err(got, server.keyswitch(lw[:b], wk.pfpksk, *pf_args))
    pf = limb_route_figures(kernels, server, lw, wk.pfpksk, wk.pfpks_key, *pf_args)
    errs.update({f"pfpks_k1_{name}": v for name, v in pf["words_differing"].items()})
    # K2's CMux entry on a real GGSW: its small route (the small-N cluster
    # kernel's CMux mode) and, in turns, the generic kernel it replaced there
    ggsw = wopbs_run["ggsw"]
    cm = {}
    for b in (1, 64):
        ct0, ct1 = rnd((b, wk.k + 1, wk.n_poly)), rnd((b, wk.k + 1, wk.n_poly))
        cm[f"b{b}"] = cmux_route_figures(kernels, server, ct0, ct1, ggsw, wk.dp,
                                         prm.cbs_base_log, prm.cbs_level, errs, f"cmux_b{b}")
        if cm[f"b{b}"]["route"] != "small":
            raise RuntimeError(f"K2's CMux entry at the tree's shape took its "
                               f"{cm[f'b{b}']['route']} route")
    # vertical packing's step route (no set of either package takes it)
    from tfhe_tpu_torch.shortint import wopbs

    tree_ggsws = wk.circuit_bootstrap_bits(wopbs_run["tree_bits"])
    table, delta = wopbs_run["tree_table"], wk.shortint_params.delta
    chain_out = wk.vertical_packing(tree_ggsws, table, delta)
    before = {c: getattr(kernels, c).launches for c in ("cmux_step", "cmux_chain", "cmux")}
    route = wopbs.low_bits_route
    wopbs.low_bits_route = lambda *shape: "step"
    try:
        step_out = wk.vertical_packing(tree_ggsws, table, delta)
    finally:
        wopbs.low_bits_route = route
    made = {c: getattr(kernels, c).launches - n for c, n in before.items()}
    n_low = min(len(wopbs_run["tree_bits"]), wk.n_poly.bit_length() - 1)
    if made != {"cmux_step": n_low, "cmux_chain": 0, "cmux": 1}:
        raise RuntimeError(f"vertical packing's step route did not run {n_low} step "
                           f"launches and one CMux launch: {made}")
    errs["vertical_packing_step_route"] = max_abs_err(
        torch.from_numpy(np.asarray(step_out.data).view(np.int64)),
        torch.from_numpy(np.asarray(chain_out.data).view(np.int64)))
    return {"k6": k6, "pfpks": pf, "cmux": cm, "step_route_launches": made}


# Phases 31-32: 3_3 on the card (K2's cluster kernel at N = 8192) and every
# shortint set that had never had a real-key round there
SERVE_3_3_BATCH = 64
RADIX_3_3_BLOCKS = 4          # a radix of 4 blocks of 3 message bits: 12 bits
PARAM_SETS_BATCH = 32
PARAM_SETS = (
    # (tag, the set's name in shortint/params.py, the rotation's counter,
    # the counter of the kernel its route must launch for every rotation)
    ("1_1", "V1_4_PARAM_MESSAGE_1_CARRY_1_KS_PBS_TUNIFORM_2M128", "blind_rotate",
     "blind_rotate_cluster"),
    ("gpu_group_2", "V1_4_PARAM_GPU_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
     "blind_rotate_multibit", "blind_rotate_multibit_cluster"),
    ("gpu_group_3", "V1_4_PARAM_GPU_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
     "blind_rotate_multibit", "blind_rotate_multibit_cluster"),
    ("gpu_group_4_1_1",
     "V1_4_PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_1_CARRY_1_KS_PBS_TUNIFORM_2M128",
     "blind_rotate_multibit", None),
)
# each set's counted runs: the round, a second (warm) round on the same
# inputs, the CHECK_BATCH check through the same entry point
PARAM_SETS_RUNS = (("", "launches"), ("_warm", "warm_launches"), ("_b4", "b4_launches"))
PARAM_SETS_TIMED = (CHECK_BATCH, PARAM_SETS_BATCH)   # the new routes against the generic kernels
PARAM_SETS_REPS = 3
CLUSTER_RANDOM_STEPS = 64     # the random-key check's steps at the 3_3 shape


def lut_fn(total: int):
    """The tables of phases 31-32: x -> (7 x + 3) mod the set's total
    plaintext space (message x carry)."""
    return lambda x: (7 * x + 3) % total


def serve_3_3_phase(kernels, shortint_mod, ti, seed: int) -> dict:
    """Phase 31: V1_4_PARAM_MESSAGE_3_CARRY_3_KS_PBS_TUNIFORM_2M128 (n =
    1077, N = 8192, l = 2, base 2^15; KS 2^4 x 5 from n_in = 8192) on the
    card through the entry points: ClientKey, ServerKey(device="cuda")
    (seconds, the key's bytes on the card), ROUNDS rounds of
    apply_lookup_table_batch at B = 64 with (7x + 3) % 64 on messages of 3
    bits, every output decrypted (K1's tensor-core kernel, then K2's cluster
    kernel once a round: the exact rotation, 3_3 being outside the v7
    family); a radix of 4 blocks (12 bits) add and mul through the integer
    layer, decrypted."""
    import numpy as np
    import torch

    q = shortint_mod.V1_4_PARAM_MESSAGE_3_CARRY_3_KS_PBS_TUNIFORM_2M128
    t0 = time.perf_counter()
    ck = shortint_mod.ClientKey(q, seed=seed)
    sk = shortint_mod.ServerKey(ck, seed=seed + 1, device="cuda")
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    if sk.trunc_acc:
        raise RuntimeError("the 3_3 key took the v7 rotation (it is outside the v7 family)")
    rng = np.random.default_rng(seed + 2)
    inputs = rng.integers(0, q.message_modulus, SERVE_3_3_BATCH)
    cts = [ck.encrypt(int(v)) for v in inputs]
    f = lut_fn(q.message_modulus * q.carry_modulus)
    lut = sk.generate_lookup_table(f)
    reset_counts(kernels)
    torch.cuda.synchronize()
    round_s, outs = [], []
    for _ in range(ROUNDS):
        t1 = time.perf_counter()
        outs.append(sk.apply_lookup_table_batch(cts, lut))
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t1)
    launches = read_counts(kernels)
    wrong = sum(ck.decrypt_raw(ct) != f(int(v)) for out in outs for ct, v in zip(out, inputs))
    line = {"params": "V1_4_PARAM_MESSAGE_3_CARRY_3_KS_PBS_TUNIFORM_2M128",
            "n": q.lwe_dimension, "N": q.polynomial_size, "k": q.glwe_dimension,
            "pbs_level": q.pbs_level, "pbs_base_log": q.pbs_base_log,
            "ks_level": q.ks_level, "ks_base_log": q.ks_base_log,
            "keygen_seconds": keygen_s,
            "device_key_bytes": {"bsk_ntt": sk.bsk_ntt.numel() * 4,
                                 "ksk_words": sk.ksk.numel() * 8,
                                 "ksk_limbs": sk.ks_key.limbs.numel()},
            "batch": SERVE_3_3_BATCH, "rounds": ROUNDS, "round_seconds": round_s,
            "pbs_per_s": ROUNDS * SERVE_3_3_BATCH / sum(round_s),
            "launches": {k: v for k, v in launches.items() if v},
            "outputs_checked": ROUNDS * SERVE_3_3_BATCH, "wrong": int(wrong)}
    check_launches("a 3_3 round", line,
                   {"keyswitch": None, "keyswitch_imma": "keyswitch",
                    "blind_rotate": None, "blind_rotate_cluster": "blind_rotate"},
                   never=("blind_rotate_exact_lazy", "blind_rotate_multibit", "keyswitch32"))
    if launches["blind_rotate_cluster"] != ROUNDS:
        raise RuntimeError(f"the 3_3 rounds did not run K2's cluster kernel once a round: "
                           f"{launches}")
    # the integer layer on the same key: a radix of 4 blocks
    ick, isk = integer_keys(ti, ck, sk)
    mod = isk.msg ** RADIX_3_3_BLOCKS
    x, y = (int(v) for v in rng.integers(0, mod, 2))
    a, b = ick.encrypt_radix(x, RADIX_3_3_BLOCKS), ick.encrypt_radix(y, RADIX_3_3_BLOCKS)
    log = RoundLog(isk.key)
    radix = {}
    for name, fn, want in (("add", lambda: isk.add_parallelized(a, b), (x + y) % mod),
                           ("mul", lambda: isk.mul_parallelized(a, b), (x * y) % mod)):
        _, radix[name] = measured_op(kernels, log, fn,
                                     lambda o, w=want: ick.decrypt_radix(o) != w, warm=False)
        check_launches(f"the 3_3 radix {name}", radix[name],
                       {"keyswitch": None, "blind_rotate": None,
                        "blind_rotate_cluster": "blind_rotate"})
    log.close()
    line["radix"] = {"blocks": RADIX_3_3_BLOCKS, "modulus": mod, **radix}
    line["wrong"] += sum(op["wrong"] for op in radix.values())
    return {"line": line, "wrong": line["wrong"], "ck": ck, "sk": sk, "cts": cts,
            "lut": lut}


def param_sets_phase(kernels, shortint_mod, seed: int) -> dict:
    """Phase 32: every set of shortint/params.py that had no real-key round
    on the card before: 1_1 (k + 1 = 5, N = 512: K2's small-N cluster
    kernel), the GPU multi-bit GROUP_2 (N = 4096) and GROUP_3 (l = 2, g =
    3), both on K3's cluster kernel, and GROUP_4 1_1 (K3 v9): keygen, one
    round at B = 32 with (7x + 3) % total decrypted, a second (warm) round
    on the same inputs, decrypted, and the first CHECK_BATCH inputs through
    the same entry point with the kernels and with their plain versions (0
    words differing); each of the three counted, and each must launch the
    route's kernel for its one rotation (no generic exact kernel).  The
    sets with a route of their own keep their key, inputs and LUT for
    param_sets_vs_plain."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import server
    from tfhe_tpu_torch.shortint import params as sp
    from tfhe_tpu_torch.shortint.server_key import upload_batch

    lines, errs, wrong, keys = {}, {}, 0, {}
    for i, (tag, name, rotation, route) in enumerate(PARAM_SETS):
        q = getattr(sp, name)
        t0 = time.perf_counter()
        ck = shortint_mod.ClientKey(q, seed=seed + 10 * i)
        sk = shortint_mod.ServerKey(ck, seed=seed + 10 * i + 1, device="cuda")
        torch.cuda.synchronize()
        keygen_s = time.perf_counter() - t0
        inputs = np.random.default_rng(seed + 10 * i + 2).integers(0, q.message_modulus,
                                                                    PARAM_SETS_BATCH)
        cts = [ck.encrypt(int(v)) for v in inputs]
        f = lut_fn(q.message_modulus * q.carry_modulus)
        lut = sk.generate_lookup_table(f)
        out, launches, round_s, _ = counted(kernels,
                                            lambda: sk.apply_lookup_table_batch(cts, lut))
        warm, warm_launches, warm_s, _ = counted(kernels,
                                                 lambda: sk.apply_lookup_table_batch(cts, lut))
        bad = int(sum(ck.decrypt_raw(ct) != f(int(v))
                      for run in (out, warm) for ct, v in zip(run, inputs)))
        few = cts[:CHECK_BATCH]
        got_cts, b4_launches, _, _ = counted(kernels,
                                             lambda: sk.apply_lookup_table_batch(few, lut))
        for what, counts in (("round", launches), ("warm round", warm_launches),
                             (f"B = {CHECK_BATCH} check", b4_launches)):
            if not counts["keyswitch"] or counts[rotation] != 1:
                raise RuntimeError(f"{name}'s {what} did not run K1 and {rotation} once: "
                                   f"{counts}")
            if route and counts[route] != 1:
                raise RuntimeError(f"{name}'s {what} did not run {route}: {counts}")
            if route and counts["blind_rotate_exact_lazy"]:
                raise RuntimeError(f"{name}'s {what} ran K2's lazy kernel: {counts}")
        got = upload_batch([c.data for c in got_cts], sk.device)
        with plain_kernels(kernels, server):
            want = upload_batch([c.data for c in sk.apply_lookup_table_batch(few, lut)],
                                sk.device)
        errs[f"param_sets_{tag}_b{CHECK_BATCH}"] = max_abs_err(got, want)
        lines[tag] = {"params": name, "n": q.lwe_dimension, "N": q.polynomial_size,
                      "k": q.glwe_dimension, "pbs_level": q.pbs_level,
                      "grouping": getattr(q, "grouping_factor", None),
                      "v7_or_v9_mode": sk.trunc_acc, "keygen_seconds": keygen_s,
                      "batch": PARAM_SETS_BATCH, "round_seconds": round_s,
                      "warm_round_seconds": warm_s, "route_counter": route,
                      "launches": {k: v for k, v in launches.items() if v},
                      "warm_launches": {k: v for k, v in warm_launches.items() if v},
                      "b4_launches": {k: v for k, v in b4_launches.items() if v},
                      f"vs_plain_b{CHECK_BATCH}_max_abs_err":
                          errs[f"param_sets_{tag}_b{CHECK_BATCH}"],
                      "outputs_checked": 2 * PARAM_SETS_BATCH, "wrong": bad}
        wrong += bad
        if route:
            keys[tag] = (sk, cts, lut)
    return {"line": {**lines, "wrong": wrong}, "errs": errs, "wrong": wrong, "keys": keys}


def generic_multibit_rotation(kernels, server, degrees, body, lut, key, dp, base_log: int,
                              levels: int):
    """K3's generic exact kernel (csrc/blind_rotate_multibit.cu
    blind_rotate_multibit_kernel) through its C entry at a shape its lazy
    kernel does not take: at the GPU GROUP_2 and GROUP_3 shapes, the kernel
    the cluster kernel replaced."""
    import torch

    from tfhe_tpu_torch.ops import ntt

    acc = server.initial_accumulator(lut, body, False).contiguous()
    deg32 = degrees.to(torch.int32).contiguous()
    b, n_groups, n_sub = degrees.shape
    k1, n_poly = acc.shape[1], acc.shape[2]
    tw_fwd, tw_inv = ntt.shoup_twiddles(dp)
    mono = server.monomial_table(dp)[0]
    err = kernels.load()["blind_rotate_multibit"].tfhe_torch_blind_rotate_multibit(
        acc.data_ptr(), deg32.data_ptr(), key.data_ptr(), dp.psi32.data_ptr(),
        dp.psi_inv32.data_ptr(), tw_fwd.data_ptr(), tw_inv.data_ptr(), mono.data_ptr(),
        dp.kernel_consts.data_ptr(), b, n_groups, n_sub.bit_length() - 1, k1,
        n_poly.bit_length() - 1, levels, dp.num_primes, base_log, kernels._stream(acc))
    if err:
        raise RuntimeError(f"K3's generic exact kernel failed: cudaError {err}")
    return acc


def param_sets_vs_plain(kernels, server, run, errs: dict) -> dict:
    """The routes of phase 32's sets that have one of their own, on the
    sets' real keys and the round's own keyswitched inputs, at B =
    CHECK_BATCH and PARAM_SETS_BATCH: K2's small-N cluster kernel at 1_1
    (k+1 = 5; through kernels.blind_rotate) and K3's cluster kernel at
    GPU GROUP_2 and GROUP_3 (through kernels.blind_rotate_multibit), each
    against the plain rotation (0 words differing) and, in turns, against
    the generic kernel's C entry (the first design, also held); ms and the
    host's ms a launch, the plain version's ms, the bound (k2_bound /
    k3_bound, four primes) and the kernel's figures."""
    import torch

    from tfhe_tpu_torch.shortint.server_key import upload_batch

    out = {}
    for tag, (sk, cts, lut) in run["keys"].items():
        q, dev = sk.params, sk.device
        batch = upload_batch([c.data for c in cts], dev)
        ks = kernels.keyswitch(batch, sk.ks_key, q.ks_base_log, q.ks_level)
        mask, body, log_mod = switched_inputs(ks, q, server)
        luts = sk._upload_luts([lut], batch.shape[0])
        grouping = getattr(q, "grouping_factor", None)
        k1, n_poly = q.glwe_dimension + 1, q.polynomial_size
        rows = {}
        for b in PARAM_SETS_TIMED:
            if grouping:
                deg = server.multibit_switched_degrees(mask[:b], grouping, log_mod)
                args = (deg, body[:b], luts[:b], sk.bsk_ntt, sk.dp, q.pbs_base_log, q.pbs_level)
                wrapper, plain = kernels.blind_rotate_multibit, server.blind_rotate_multibit
                generic = generic_multibit_rotation
                bound = k3_bound(deg, luts[:b], q.pbs_level, q.pbs_base_log, EXACT_PRIMES, False)
            else:
                msed = server.modulus_switch(mask[:b], log_mod)
                args = (msed, body[:b], luts[:b], sk.bsk_ntt, sk.dp, q.pbs_base_log, q.pbs_level)
                wrapper, plain = kernels.blind_rotate, server.blind_rotate
                generic = generic_exact_rotation
                bound = k2_bound(msed, luts[:b], q.pbs_level, q.pbs_base_log, EXACT_PRIMES)
            before = wrapper.cluster_launches
            got = wrapper(*args)
            if wrapper.cluster_launches != before + 1:
                raise RuntimeError(f"{tag}'s rotation at B = {b} did not take its cluster kernel")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            name = "k3_cluster" if grouping else "k2_small_k5"
            errs[f"{name}_{tag}_b{b}"] = max_abs_err(got, want)
            errs[f"{name}_generic_{tag}_b{b}"] = max_abs_err(
                generic(kernels, server, *args), want)
            t = in_turns({"route": lambda a=args, w=wrapper: w(*a),
                          "generic": lambda a=args, g=generic: g(kernels, server, *a)},
                         PARAM_SETS_REPS)
            ms = min(x[0] for x in t["route"])
            rows[f"b{b}"] = {
                "ms": ms, "host_ms": min(x[1] for x in t["route"]),
                "generic_ms": min(x[0] for x in t["generic"]),
                "generic_host_ms": min(x[1] for x in t["generic"]), "turns": t,
                "plain_ms": plain_ms, "bound_ms": bound["ms"], "bound_by": bound["by"],
                "bound_bytes_ms": bound["bytes_ms"], "bound_ntt_int32_ms": bound["ntt_ms"],
                "share_of_bound": bound["ms"] / ms,
                "shape": [b, (q.lwe_dimension // grouping) if grouping else q.lwe_dimension,
                          k1, n_poly, q.pbs_level, q.pbs_base_log]
                         + ([1 << grouping] if grouping else [])}
        figures = (kernels.multibit_cluster_figures(n_poly, q.pbs_level, grouping) if grouping
                   else kernels.cluster_figures(k1, n_poly, q.pbs_level))
        out[tag] = {"params": run["line"][tag]["params"], **figures, **rows}
        del batch, ks
    return out


def cluster_figures(kernels, server, torus, run, seed: int, errs: dict) -> dict:
    """K2's cluster kernel against the plain exact rotation (tolerance 0):
    B = CHECK_BATCH of phase 31's switched inputs on the real 3_3 key
    (all 1077 steps), and a random key at the same shape over
    CLUSTER_RANDOM_STEPS steps at B = 1, 3 and CHECK_BATCH; its time at
    phase 31's B = 64 and at B = CHECK_BATCH, the plain rotation's at
    CHECK_BATCH, the bound (k2_bound, 4 primes) at B = 64."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.shortint.server_key import upload_batch

    sk, p = run["sk"], run["sk"].params
    dev = sk.device
    batch = upload_batch([c.data for c in run["cts"]], dev)
    ks = kernels.keyswitch(batch, sk.ks_key, p.ks_base_log, p.ks_level)
    mask, body, log_mod = switched_inputs(ks, p, server)
    msed = server.modulus_switch(mask, log_mod)
    lut = sk._upload_luts([run["lut"]], batch.shape[0])
    args = (sk.bsk_ntt, sk.dp, p.pbs_base_log, p.pbs_level)
    few = (msed[:CHECK_BATCH], body[:CHECK_BATCH], lut[:CHECK_BATCH])
    before = kernels.blind_rotate.cluster_launches
    got = kernels.blind_rotate(*few, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = server.blind_rotate(*few, *args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    errs[f"k2_cluster_3_3_key_b{CHECK_BATCH}"] = max_abs_err(got, want)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    k1, n_poly = p.glwe_dimension + 1, p.polynomial_size
    rkey = random_ntt_key((CLUSTER_RANDOM_STEPS, p.pbs_level, k1, k1), sk.dp, gen)
    for b in (1, 3, CHECK_BATCH):
        m = torch.from_numpy(rng.integers(0, 2 * n_poly, (b, CLUSTER_RANDOM_STEPS))).to(dev)
        bd = torch.from_numpy(rng.integers(0, 2 * n_poly, (b,))).to(dev)
        lt = torus.from_u64(rng.integers(0, 1 << 64, (b, k1, n_poly), dtype=np.uint64), dev)
        errs[f"k2_cluster_random_key_b{b}"] = max_abs_err(
            kernels.blind_rotate(m, bd, lt, rkey, sk.dp, p.pbs_base_log, p.pbs_level),
            server.blind_rotate(m, bd, lt, rkey, sk.dp, p.pbs_base_log, p.pbs_level))
    if kernels.blind_rotate.cluster_launches - before != 4:
        raise RuntimeError("the 3_3-shape checks did not run K2's cluster kernel")
    ms = cuda_ms(lambda: kernels.blind_rotate(msed, body, lut, *args), 2)
    ms_few = cuda_ms(lambda: kernels.blind_rotate(*few, *args), 2)
    smem = kernels.exact_smem_bytes(k1, n_poly, p.pbs_level, cluster=True)
    return {"ms": ms, "b4_ms": ms_few, "plain_b4_ms": plain_s * 1e3,
            "bound": k2_bound(msed, lut, p.pbs_level, p.pbs_base_log, EXACT_PRIMES),
            "b4_bound": k2_bound(few[0], few[2], p.pbs_level, p.pbs_base_log, EXACT_PRIMES),
            "shared_memory_bytes": smem, "generic_kernel_bytes": kernels.exact_smem_bytes(
                k1, n_poly, p.pbs_level),
            "shape": [msed.shape[0], p.lwe_dimension, p.pbs_level, k1, n_poly]}


# Phase 33: the GLWE keyswitch (K7), the common mask and the experimental
# core (K8) at the widths of V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
# the set both packages serve (neither defines a CM or an extended-PBS set)
RESEARCH_BATCH = 512
RESEARCH_PBS_BATCH = 64
CM_SLOTS = 3
GLWE_KS_DECOMP = (8, 4)       # base 2^8, l = 4
PARTIAL_FILL = 3072           # the fast keyswitch's k_in = 2 partial key: 3072 of 4096 random
CM_WIDE_SLOTS = 4             # the first C the generic kernel could not hold at 2_2
CM_CMUX_SLOTS = (3, 4, 7)     # the CM CMux: C = 3, the first C the card refused before, C = 7
EXT_FACTORS = (1, 2, 4)
RESEARCH_STEPS = ("glwe_keyswitch", "fast_keyswitch", "shrinking_keyswitch", "cm_keyswitch",
                  "cm_packing", "cm_bootstrap", "cm_bootstrap_c4", "cm_bootstrap_c1",
                  *(f"cm_cmux_c{c}" for c in CM_CMUX_SLOTS), "cm_external_product_c3",
                  *(f"extended_pbs_e{e}" for e in EXT_FACTORS))
RESEARCH_PLAIN_STEPS = 64     # the rotations' plain comparisons: B = CHECK_BATCH, a random key
EXT_PLAIN_FACTORS = (1, 2, 4, 8)
CM_PLAIN_K1 = (3, 4, 5, 8)    # the cluster kernel's CM shapes held against the plain rotation
K8_GENERIC_DECOMP = (15, 2)   # l = 2 at the 2_2 widths: a shape still routed to K8's generic
                              # kernel


def k7_bound(glwe, key, out) -> dict:
    """Least time for the GLWE keyswitch: the GLWEs, the key (4-prime NTT
    domain, u32 residues) and the output moved once, against its 4-prime
    CRT-NTT operations on the CUDA cores' integer rate (three 32-bit
    multiplies a Montgomery product): per GLWE the k_in l digit
    polynomials' forward transforms, the k_in l (k_out+1) key products, the
    k_out+1 inverse transforms and Garner."""
    b, _, n_poly = glwe.shape
    k_in, levels, kout1, nprimes, _ = key.shape
    butterflies = (n_poly // 2) * (n_poly.bit_length() - 1)
    modmuls = (k_in * levels * nprimes * butterflies + k_in * levels * kout1 * nprimes * n_poly
               + kout1 * nprimes * butterflies + kout1 * n_poly * nprimes * (nprimes - 1) // 2)
    t_ops = b * 3 * modmuls / INT32_MUL_PER_S
    t_bytes = (8 * glwe.numel() + 4 * key.numel() + 8 * out.numel()) / HBM_BYTES_PER_S
    return {"ms": max(t_bytes, t_ops) * 1e3, "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "ntt_int32_ms": t_ops * 1e3}


def first_glwe_keyswitch(kernels, glwe, key, dp, base_log: int, levels: int, add_sum: bool):
    """K7's first kernel (csrc/glwe_keyswitch.cu glwe_keyswitch_kernel, one
    block a GLWE) through its C entry: at the research shapes, the kernel
    the cluster kernel replaced."""
    import torch

    b, kin1, n_poly = glwe.shape
    kout1 = key.shape[2]
    out = torch.empty((b, kout1, n_poly), dtype=torch.int64, device=glwe.device)
    err = kernels.load()["glwe_keyswitch"].tfhe_torch_glwe_keyswitch(
        out.data_ptr(), glwe.data_ptr(), key.data_ptr(), dp.psi32.data_ptr(),
        dp.psi_inv32.data_ptr(), dp.kernel_consts.data_ptr(), b, kin1 - 1, kout1,
        n_poly.bit_length() - 1, levels, base_log, int(add_sum),
        min(kernels.glwe_keyswitch_rows(kout1, n_poly), (kin1 - 1) * levels),
        kernels._stream(glwe))
    if err:
        raise RuntimeError(f"K7's first kernel failed: cudaError {err}")
    return out


def k8_bound(mask, acc, levels: int, base_log: int) -> dict:
    """Least time for the extended rotation of B ciphertexts of E slots: E
    times k2_bound's operations at the same B (each slot a classic
    rotation's work), the key read once, the accumulators once."""
    import torch

    b, e, k1, n_poly = acc.shape
    slots_mask = torch.zeros((b * e, mask.shape[1]), dtype=torch.int32)
    return k2_bound(slots_mask, acc.reshape(b * e, k1, n_poly), levels, base_log, EXACT_PRIMES)


def encrypt_glwes(kg, sk, plaintexts, noise, gen, dev):
    """B GLWEs (B, k+1, N) under sk of the (B, N) uint64 plaintexts, as
    encrypting them one after the other with encrypt_glwe_assign: the mask
    and noise streams drawn whole, the secret products on the card
    (keygen.add_mask_times_secret)."""
    import numpy as np

    b, n_poly = plaintexts.shape
    k = sk.glwe_dimension
    rows = np.zeros((b, k + 1, n_poly), dtype=np.uint64)
    rows[:, :k] = gen.mask.uniform_u64(b * k * n_poly).reshape(b, k, n_poly)
    with np.errstate(over="ignore"):
        rows[:, k] = plaintexts + noise.sample(gen.noise, b * n_poly).reshape(b, n_poly)
    kg.add_mask_times_secret(rows, sk, dev)
    return rows


def encrypt_cm_glwes(kg, sks, plaintexts, noise, gen, dev):
    """B CM GLWEs (B, k + C, N) under the C GLWE keys sks of the (B, C, N)
    uint64 plaintexts (core/cm.py encrypt_cm_glwe's layout: a shared
    k-polynomial mask, a body a key): the mask and noise streams drawn
    whole, the secret products on the card (keygen.add_mask_times_secret,
    one key a slot)."""
    import numpy as np

    b, c, n_poly = plaintexts.shape
    k = sks[0].glwe_dimension
    rows = np.zeros((b, k + c, n_poly), dtype=np.uint64)
    rows[:, :k] = gen.mask.uniform_u64(b * k * n_poly).reshape(b, k, n_poly)
    with np.errstate(over="ignore"):
        rows[:, k:] = plaintexts + noise.sample(gen.noise, b * c * n_poly).reshape(b, c, n_poly)
    for j, sk in enumerate(sks):
        part = np.ascontiguousarray(np.concatenate([rows[:, :k], rows[:, k + j, None]], axis=1))
        kg.add_mask_times_secret(part, sk, dev)
        rows[:, k + j] = part[:, k]
    return rows


def decode_glwes(ntt, torus, sk, glwes, delta: int, dp):
    """The messages round(plaintext / delta) mod 16 of (B, k+1, N) GLWEs
    under sk, decrypted on the card."""
    import numpy as np
    import torch

    key = ntt.key_ntt(sk.data.astype(np.uint64), dp).to(torch.int64)
    plain = glwes[:, -1] - ntt.mask_times_binary_key(glwes[:, :-1].contiguous(), key, dp)
    return torus.shr(plain + delta // 2, delta.bit_length() - 1) & 15


def decode_lwes(torus, key_bits, lwes, delta: int):
    """round((body - <mask, s>) / delta) mod 16 of (B, n+1) LWEs on the card
    (key_bits (n,) or, for C slots of a CmLwe, (n, C))."""
    import numpy as np
    import torch

    bits = torch.from_numpy(np.asarray(key_bits).astype(np.int64)).to(lwes.device)
    n = bits.shape[0]
    dots = (lwes[:, :n, None] * bits.reshape(n, -1)[None]).sum(dim=1)
    plain = lwes[:, n:] - dots
    return torus.shr(plain + delta // 2, delta.bit_length() - 1) & 15


def research_primitives_phase(kernels, torus, ck, sk, seed: int) -> dict:
    """Phase 33: at the 2_2 widths (n = 918, k = 1, N = 2048, PBS 2^23 x 1,
    KS 2^4 x 4, TUniform(45) and TUniform(17)), keygens on the card from
    fixed seeds, each step through its entry point with every output
    decrypted: the GLWE keyswitch (K7, (0, body) - sum) of B = 512 GLWEs
    from a fresh k = 1 key to phase 3's GLWE key, base 2^8 x 4; the fast
    keyswitch (K7, sum + (0, body)) from a k_in = 2 partial key on a
    pseudo-GGSW; the shrinking keyswitch (K1) from phase 3's flattened
    2048-coefficient key to its 918-coefficient prefix; the CM keyswitch
    (K1 once) and CM packing (K1 a slot), 2048 -> 918 at C = 3; the CM
    bootstrap (K2's cluster kernel at k+1 = 4) of 64 CmLwes with (3x + 1) %
    16, the same at C = 4 on keys of its own (the cluster kernel at k+1 =
    5), and one C = 1 call (K2's lazy kernel) on the C = 3 key's first
    slot; the CM CMux of 64 pairs at C = 3, 4 and 7 and the CM external
    product at C = 3 (K2's CMux entry, its cluster route: the N = 2048
    cluster kernel's CMux mode) on a CM GGSW of fixed per-slot bits, every
    slot decrypted, every output against server.cmux, the generic kernel
    in turns at C = 3; the extended PBS (K8's lazy kernel) of 64 LWEs at E = 1, 2 and 4
    on phase 3's exact key with (x^2 + 3) % 16, at E = 1 against K2's exact
    rotation.  Seconds, kernel CUDA-event ms, launches, routes, keygen
    seconds, key bytes, a block's shared memory and the clusters the card
    holds at once."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.core import cm, experimental, keygen
    from tfhe_tpu_torch.core.params import DecompParams
    from tfhe_tpu_torch.ops import ntt, server
    from tfhe_tpu_torch.utils import csprng

    p = ck.params
    dev = torch.device("cuda")
    n, k, n_poly, delta = p.lwe_dimension, p.glwe_dimension, p.polynomial_size, p.delta
    sec = csprng.SecretRandomGenerator(seed)
    gen = csprng.EncryptionRandomGenerator(seed + 1, csprng.DeterministicSeeder(seed + 2))
    rng = np.random.default_rng(seed + 3)
    dp = sk.dp
    lines, run, wrong = {}, {"dp": dp}, 0

    def keygen_timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def step(tag, fn, check, must: dict, kernel_ms=None, **extra):
        nonlocal wrong
        out, launches, seconds, _ = counted(kernels, fn)
        if launches != only(kernels, **must):
            raise RuntimeError(f"the {tag} step did not launch {must} alone: {launches}")
        bad = int(check(out))
        wrong += bad
        lines[tag] = {"seconds": seconds, "launches": {k_: v for k_, v in launches.items() if v},
                      "wrong": bad, **({"kernel_ms": kernel_ms()} if kernel_ms else {}), **extra}
        return out

    # 1-2. the GLWE keyswitch and the fast keyswitch (K7, both signs)
    base_log, levels = GLWE_KS_DECOMP
    decomp = DecompParams(base_log, levels)
    sk_in = keygen.generate_binary_glwe_secret_key(k, n_poly, sec)
    sk_out = ck.glwe_secret_key
    gksk, gksk_s = keygen_timed(lambda: keygen.generate_glwe_keyswitch_key(
        sk_in, sk_out, decomp, p.glwe_noise, gen, device=dev))
    msgs = rng.integers(0, 16, (RESEARCH_BATCH, n_poly)).astype(np.uint64)
    with np.errstate(over="ignore"):
        pts = msgs * np.uint64(delta)
    msgs_t = torch.from_numpy(msgs.astype(np.int64)).to(dev)
    glwes = torus.from_u64(encrypt_glwes(keygen, sk_in, pts, p.glwe_noise, gen, dev), dev)

    def glwe_wrong(out):
        return (decode_glwes(ntt, torus, sk_out, out, delta, dp) != msgs_t).any(dim=1).sum()

    ks_out = step("glwe_keyswitch", lambda: server.glwe_keyswitch(glwes, gksk.data, gksk.dp,
                                                                    base_log, levels),
                  glwe_wrong, {"glwe_keyswitch": 1, "glwe_keyswitch_cluster": 1},
                  lambda: cuda_ms(lambda: kernels.glwe_keyswitch(glwes, gksk.data, gksk.dp,
                                                                 base_log, levels), 5),
                  batch=RESEARCH_BATCH, k_in=k, k_out=k, keygen_seconds=gksk_s,
                  key_device_bytes=gksk.data.numel() * 4)
    sk_partial = experimental.generate_partial_binary_glwe_secret_key(2, n_poly, PARTIAL_FILL, sec)
    pggsw, pggsw_s = keygen_timed(lambda: experimental.pseudo_ggsw_to_ntt(
        experimental.encrypt_pseudo_ggsw(sk_out, sk_partial, decomp, p.glwe_noise, gen,
                                         device=dev), device=dev))
    glwes2 = torus.from_u64(encrypt_glwes(keygen, sk_partial, pts, p.glwe_noise, gen, dev), dev)
    fast_out = step("fast_keyswitch", lambda: experimental.glwe_fast_keyswitch(
        glwes2, pggsw.data, pggsw.dp, base_log, levels), glwe_wrong,
        {"glwe_keyswitch": 1, "glwe_keyswitch_cluster": 1},
        lambda: cuda_ms(lambda: kernels.glwe_keyswitch(glwes2, pggsw.data, pggsw.dp, base_log,
                                                       levels, add_sum=True), 5),
        batch=RESEARCH_BATCH, k_in=2, k_out=k, partial_fill=PARTIAL_FILL,
        keygen_seconds=pggsw_s, key_device_bytes=pggsw.data.numel() * 4)
    run["k7"] = {"glwe": (glwes, gksk, ks_out), "fast": (glwes2, pggsw, fast_out),
                 "decomp": GLWE_KS_DECOMP}

    # 3. the shrinking keyswitch (K1), 2048 -> its 918-coefficient prefix
    ks_decomp = DecompParams(p.ks_base_log, p.ks_level)
    big = ck.big_lwe_secret_key
    sksk, sksk_s = keygen_timed(lambda: experimental.generate_lwe_shrinking_keyswitch_key(
        big, n, ks_decomp, p.lwe_noise, gen, device=dev))
    lwe_msgs = rng.integers(0, 16, RESEARCH_BATCH)
    lwe_msgs_t = torch.from_numpy(lwe_msgs).to(dev)
    big_cts = torus.from_u64(cm.encrypt_cm_lwe_batch(
        [big], (lwe_msgs.astype(np.uint64) * np.uint64(delta))[:, None], p.glwe_noise, gen, dev),
        dev)
    shrunk = step("shrinking_keyswitch", lambda: experimental.shrinking_keyswitch(big_cts, sksk),
                  lambda out: (decode_lwes(torus, big.data[:n], out, delta)[:, 0]
                               != lwe_msgs_t).sum(),
                  {"keyswitch": 1, "keyswitch_imma": 1},
                  lambda: cuda_ms(lambda: kernels.keyswitch(
                      torch.cat([big_cts[:, n:-1], big_cts[:, -1:]], dim=1), sksk.key,
                      p.ks_base_log, p.ks_level), 10),
                  batch=RESEARCH_BATCH, n_in=big.dimension, shared=n, keygen_seconds=sksk_s,
                  key_shape=list(sksk.ksk.data.shape))
    run["shrinking"] = (big_cts, sksk, shrunk)

    # 4. the CM keyswitch (K1 once) and the CM packing (K1 a slot), C = 3
    in_sks = [keygen.generate_binary_lwe_secret_key(big.dimension, sec) for _ in range(CM_SLOTS)]
    out_sks = [keygen.generate_binary_lwe_secret_key(n, sec) for _ in range(CM_SLOTS)]
    out_bits = np.stack([s.data for s in out_sks], axis=1)
    cksk, cksk_s = keygen_timed(lambda: cm.generate_cm_lwe_keyswitch_key(
        in_sks, out_sks, ks_decomp, p.lwe_noise, gen, device=dev))
    cm_msgs = rng.integers(0, 16, (RESEARCH_BATCH, CM_SLOTS))
    cm_msgs_t = torch.from_numpy(cm_msgs).to(dev)
    cm_pts = cm_msgs.astype(np.uint64) * np.uint64(delta)
    cm_cts = torus.from_u64(cm.encrypt_cm_lwe_batch(in_sks, cm_pts, p.glwe_noise, gen, dev), dev)

    def cm_wrong(out):
        return (decode_lwes(torus, out_bits, out, delta) != cm_msgs_t).sum()

    cm_out = step("cm_keyswitch", lambda: cm.cm_keyswitch(cm_cts, cksk), cm_wrong,
                  {"keyswitch": 1, "keyswitch_imma": 1},
                  lambda: cuda_ms(lambda: kernels.keyswitch(
                      torch.cat([cm_cts[:, :-CM_SLOTS], cm_cts[:, :1] * 0], dim=1), cksk.key,
                      p.ks_base_log, p.ks_level), 10),
                  batch=RESEARCH_BATCH, slots=CM_SLOTS, n_in=big.dimension, n_out=n,
                  keygen_seconds=cksk_s, key_device_bytes=cksk.data.size * 8)
    run["cm_keyswitch"] = (cm_cts, cksk, cm_out)
    pk, pk_s = keygen_timed(lambda: cm.generate_cm_lwe_packing_key(
        big, out_sks, ks_decomp, p.lwe_noise, gen, device=dev))
    std = torus.from_u64(cm.encrypt_cm_lwe_batch(
        [big], cm_pts.reshape(-1, 1), p.glwe_noise, gen, dev), dev).reshape(
        RESEARCH_BATCH, CM_SLOTS, -1)
    step("cm_packing", lambda: cm.pack_lwe_ciphertexts_into_cm(std, pk), cm_wrong,
         {"keyswitch": CM_SLOTS, "keyswitch_imma": CM_SLOTS}, batch=RESEARCH_BATCH,
         slots=CM_SLOTS, keygen_seconds=pk_s, key_device_bytes=pk.data.size * 8)
    del pk, std

    # 5. the CM bootstrap (K2 at k+1 = 4: its cluster kernel), then C = 4 on
    # keys of its own (k+1 = 5) and C = 1 on the C = 3 key's first slot (k+1
    # = 2: its lazy kernel)
    glwe_sks = [keygen.generate_binary_glwe_secret_key(k, n_poly, sec) for _ in range(CM_SLOTS)]
    pbs = DecompParams(p.pbs_base_log, p.pbs_level)
    f = lambda x: (3 * x + 1) % 16  # noqa: E731
    lut = torus.from_u64(server.generate_lut(n_poly, k + 1, 16, delta, f)[-1], dev)

    def cm_pbs(tag, in_sks, g_sks):
        """One CM bootstrap of RESEARCH_PBS_BATCH CmLwes at C = len(in_sks)
        through cm.cm_bootstrap, each slot decrypted; returns its key and
        inputs and the rotation's inputs as cm_blind_rotate forms them."""
        c_dim = len(in_sks)
        flat = np.stack([s_.data.reshape(-1) for s_ in g_sks], axis=1)
        bsk, bsk_s = keygen_timed(lambda: cm.cm_bootstrap_key_to_ntt(
            cm.generate_cm_lwe_bootstrap_key(in_sks, g_sks, pbs, p.glwe_noise, gen, device=dev),
            device=dev))
        msgs_ = rng.integers(0, 16, (RESEARCH_PBS_BATCH, c_dim))
        want_ = torch.from_numpy(np.vectorize(f)(msgs_)).to(dev)
        cts = torus.from_u64(cm.encrypt_cm_lwe_batch(
            in_sks, msgs_.astype(np.uint64) * np.uint64(delta), p.lwe_noise, gen, dev), dev)
        k1 = k + c_dim
        route = kernels.exact_rotation_route(k1, n_poly, p.pbs_level, p.pbs_base_log, False)
        msed = server.modulus_switch(cts, n_poly.bit_length())
        acc = torch.zeros((RESEARCH_PBS_BATCH, k1, n_poly), dtype=torch.int64, device=dev)
        acc[:, k:] = server.monomial_div(lut.expand(RESEARCH_PBS_BATCH, c_dim, n_poly),
                                         msed[:, n:, None])
        step(tag, lambda: cm.cm_bootstrap(cts, lut, bsk.data, bsk.dp, p.pbs_base_log,
                                          p.pbs_level, k),
             lambda out: (decode_lwes(torus, flat, out, delta) != want_).sum(),
             {"blind_rotate": 1, "blind_rotate_cluster": 1},
             lambda: cuda_ms(lambda: kernels.rotate_accumulator(
                 acc, msed[:, :n], bsk.data, bsk.dp, p.pbs_base_log, p.pbs_level), 2),
             batch=RESEARCH_PBS_BATCH, slots=c_dim, route=route,
             slot_outputs_checked=RESEARCH_PBS_BATCH * c_dim, keygen_seconds=bsk_s,
             key_device_bytes=bsk.data.numel() * 4,
             **kernels.cluster_figures(k1, n_poly, p.pbs_level),
             generic_kernel_would_need_bytes=kernels.exact_smem_bytes(k1, n_poly, p.pbs_level))
        if route != "cluster":
            raise RuntimeError(f"the CM rotation at k+1 = {k1} took K2's {route} kernel")
        return {"ms": lines[tag]["kernel_ms"], "key": bsk, "cts": cts, "flat": flat,
                "want": want_, "acc": acc, "msed": msed[:, :n],
                "bound": k2_bound(msed[:, :n], acc, p.pbs_level, p.pbs_base_log, EXACT_PRIMES),
                "shape": [RESEARCH_PBS_BATCH, n, p.pbs_level, k1, n_poly]}

    c3 = cm_pbs("cm_bootstrap", out_sks, glwe_sks)
    cm_bsk = c3["key"]
    # the same rotation on K2's generic kernel (its C entry), the kernel the
    # cluster kernel replaced at k+1 = 4, and both at k+1 = 3 (the C = 3
    # key's first three rows and columns)
    args3 = (p.pbs_base_log, p.pbs_level)
    key3 = cm_bsk.data[:, :, :k + 2, :k + 2].contiguous()
    acc3 = c3["acc"][:, :k + 2].contiguous()
    run["cm_bootstrap"] = {
        **{key_: c3[key_] for key_ in ("ms", "bound", "shape")},
        "generic_ms": cuda_ms(lambda: generic_exact_rotate(
            kernels, c3["acc"], c3["msed"], cm_bsk.data, cm_bsk.dp, *args3), 2),
        "k1_3": {"ms": cuda_ms(lambda: kernels.rotate_accumulator(
                     acc3, c3["msed"], key3, cm_bsk.dp, *args3), 2),
                 "generic_ms": cuda_ms(lambda: generic_exact_rotate(
                     kernels, acc3, c3["msed"], key3, cm_bsk.dp, *args3), 2),
                 "bound_ms": k2_bound(c3["msed"], acc3, p.pbs_level, p.pbs_base_log,
                                      EXACT_PRIMES)["ms"]}}
    lines["cm_bootstrap"]["generic_kernel_ms"] = run["cm_bootstrap"]["generic_ms"]
    lines["cm_bootstrap"]["k1_3"] = run["cm_bootstrap"]["k1_3"]
    del key3, acc3
    one = cm_bsk.data[:, :, :k + 1, :k + 1].contiguous()
    one_cts = torch.cat([c3["cts"][:, :n], c3["cts"][:, n:n + 1]], dim=1)
    step("cm_bootstrap_c1", lambda: cm.cm_bootstrap(one_cts, lut, one, cm_bsk.dp,
                                                    p.pbs_base_log, p.pbs_level, k),
         lambda out: (decode_lwes(torus, c3["flat"][:, :1], out, delta)
                      != c3["want"][:, :1]).sum(),
         {"blind_rotate": 1, "blind_rotate_exact_lazy": 1}, batch=RESEARCH_PBS_BATCH, slots=1)
    del cm_bsk, one, c3
    torch.cuda.empty_cache()
    in4 = out_sks + [keygen.generate_binary_lwe_secret_key(n, sec)
                     for _ in range(CM_WIDE_SLOTS - CM_SLOTS)]
    g4 = glwe_sks + [keygen.generate_binary_glwe_secret_key(k, n_poly, sec)
                     for _ in range(CM_WIDE_SLOTS - CM_SLOTS)]
    c4 = cm_pbs("cm_bootstrap_c4", in4, g4)
    run["cm_bootstrap_c4"] = {key_: c4[key_] for key_ in ("ms", "bound", "shape")}
    del c4
    torch.cuda.empty_cache()

    # 6. the CM CMux (K2's CMux entry at k+1 = k + C: its cluster route) at
    # C = 3, 4, 7, and the CM external product at C = 3, of B =
    # RESEARCH_PBS_BATCH pairs encrypted from known bodies, on a CM GGSW of
    # fixed per-slot bits; every slot decrypted (cm.decrypt_cm_glwe)
    g7 = g4 + [keygen.generate_binary_glwe_secret_key(k, n_poly, sec)
               for _ in range(max(CM_CMUX_SLOTS) - len(g4))]
    shift = delta.bit_length() - 1
    run["cm_cmux"] = {}

    def cm_cmux_step(tag, c_dim, fn, ct0, ct1, bits, want, ggsw):
        """One CM CMux step through fn (cm.cm_cmux or cm_external_product),
        every slot of every output decrypted against want (B, C, N), and its
        words against server.cmux; the kernel timed from CUDA graphs of
        kernels.cmux on (ct0, ct1)."""
        nonlocal wrong
        sks_c = g7[:c_dim]
        k1 = k + c_dim
        args = (ggsw.data, ggsw.dp, p.pbs_base_log, p.pbs_level)

        def slots_wrong(out):
            words = torus.to_u64(out)
            with np.errstate(over="ignore"):
                dec = np.stack([(cm.decrypt_cm_glwe(sks_c, w) + np.uint64(delta // 2))
                                >> np.uint64(shift) for w in words]) & np.uint64(15)
            return int((dec != want).any(axis=2).sum())

        out = step(tag, fn, slots_wrong, {"cmux": 1, "cmux_cluster": 1},
                   lambda: graph_ms(lambda: kernels.cmux(ct0, ct1, *args)),
                   batch=RESEARCH_PBS_BATCH, slots=c_dim, bits=bits,
                   route=kernels.cmux_route(k1, n_poly, p.pbs_level, p.pbs_base_log),
                   slot_outputs_checked=RESEARCH_PBS_BATCH * c_dim,
                   **kernels.cmux_figures(k1, n_poly, p.pbs_level),
                   generic_kernel_would_need_bytes=kernels.exact_smem_bytes(k1, n_poly,
                                                                           p.pbs_level))
        if lines[tag]["route"] != "cluster":
            raise RuntimeError(f"the CM CMux at k+1 = {k1} took K2's {lines[tag]['route']} "
                               f"CMux route")
        plain = server.cmux(ct0, ct1, *args)
        lines[tag]["vs_plain_words_differing"] = int((out != plain).sum())
        lines[tag]["plain_ms"] = cuda_ms(lambda: server.cmux(ct0, ct1, *args), 1)
        wrong += lines[tag]["vs_plain_words_differing"]
        bound = cmux_bound(ct0, p.pbs_level, p.pbs_base_log)
        lines[tag]["bound_ms"] = bound["ms"]
        lines[tag]["share_of_bound"] = bound["ms"] / lines[tag]["kernel_ms"]
        return {"ms": lines[tag]["kernel_ms"], "bound": bound, "launches": 1,
                "smem": lines[tag]["shared_memory_bytes"],
                "vs_plain_words_differing": lines[tag]["vs_plain_words_differing"],
                "plain_ms": lines[tag]["plain_ms"],
                "shape": [RESEARCH_PBS_BATCH, k1, n_poly, p.pbs_level, p.pbs_base_log]}

    for c_dim in CM_CMUX_SLOTS:
        bits = [int(b_) for b_ in rng.integers(0, 2, c_dim)]
        bits[0], bits[-1] = 0, 1           # both selections in every step
        ggsw, ggsw_s = keygen_timed(lambda: cm.cm_ggsw_to_ntt(cm.encrypt_cm_ggsw(
            g7[:c_dim], bits, pbs, p.glwe_noise, gen, device=dev), device=dev))
        m0, m1 = rng.integers(0, 16, (2, RESEARCH_PBS_BATCH, c_dim, n_poly)).astype(np.uint64)
        ct0, ct1 = (torus.from_u64(encrypt_cm_glwes(keygen, g7[:c_dim], m * np.uint64(delta),
                                                    p.glwe_noise, gen, dev), dev)
                    for m in (m0, m1))
        sel = np.asarray(bits, dtype=bool)[None, :, None]
        args = (ggsw.data, ggsw.dp, p.pbs_base_log, p.pbs_level)
        fig = cm_cmux_step(f"cm_cmux_c{c_dim}", c_dim, lambda: cm.cm_cmux(ct0, ct1, *args),
                           ct0, ct1, bits, np.where(sel, m1, m0), ggsw)
        lines[f"cm_cmux_c{c_dim}"]["keygen_seconds"] = ggsw_s
        if c_dim == CM_SLOTS:
            # the generic kernel (its C entry), which held C <= 3 at these
            # widths, in turns with the cluster route
            times = {"cluster": [], "generic": []}
            runs = {"cluster": lambda: kernels.cmux(ct0, ct1, *args),
                    "generic": lambda: generic_cmux(kernels, ct0, ct1, *args)}
            for name in ("cluster", "generic", "generic", "cluster"):
                times[name].append(graph_ms(runs[name]))
            fig["in_turns"] = times
            fig["generic_ms"] = min(times["generic"])
            lines[f"cm_cmux_c{c_dim}"]["generic_kernel_ms"] = fig["generic_ms"]
            lines[f"cm_cmux_c{c_dim}"]["in_turns_ms"] = times
            zeros = torch.zeros_like(ct1)
            fig["external_product"] = cm_cmux_step(
                "cm_external_product_c3", c_dim,
                lambda: cm.cm_external_product(ct1, *args), zeros, ct1, bits,
                np.where(sel, m1, 0), ggsw)
        run["cm_cmux"][c_dim] = fig
        del ggsw, ct0, ct1
    torch.cuda.empty_cache()

    # 7. the extended PBS (K8's lazy kernel) at E = 1, 2, 4 on phase 3's exact key
    key = sk.exact_bsk_ntt()
    g = lambda x: (x * x + 3) % 16  # noqa: E731
    ext_msgs = rng.integers(0, 16, RESEARCH_PBS_BATCH)
    ext_want = torch.from_numpy(np.vectorize(g)(ext_msgs)).to(dev)
    small_cts = torus.from_u64(cm.encrypt_cm_lwe_batch(
        [ck.lwe_secret_key], (ext_msgs.astype(np.uint64) * np.uint64(delta))[:, None],
        p.lwe_noise, gen, dev), dev)
    run["k8"] = {}
    for e in EXT_FACTORS:
        lut_e = torus.from_u64(server.generate_lut(n_poly * e, k + 1, 16, delta, g), dev)
        lut_b = lut_e.expand(RESEARCH_PBS_BATCH, k + 1, n_poly * e)
        msed = server.modulus_switch(small_cts, (2 * n_poly * e).bit_length() - 1)
        acc0 = experimental.split_extended_lut(
            server.monomial_div(lut_b, msed[:, -1, None, None]), e)
        figs = kernels.extended_figures(e, RESEARCH_PBS_BATCH, k + 1, n_poly, p.pbs_level,
                                        p.pbs_base_log)
        out = step(f"extended_pbs_e{e}", lambda: experimental.extended_pbs_batch(
            small_cts, lut_b, key, dp, p.pbs_base_log, p.pbs_level, e),
            lambda o: (decode_lwes(torus, big.data, o, delta)[:, 0] != ext_want).sum(),
            {"blind_rotate_extended": 1, "blind_rotate_extended_lazy": 1},
            lambda: cuda_ms(lambda: kernels.blind_rotate_extended(
                msed[:, :-1], acc0, key, dp, p.pbs_base_log, p.pbs_level), 3),
            batch=RESEARCH_PBS_BATCH, ext_factor=e, lut_size=n_poly * e, **figs)
        if figs["route"] != "lazy":
            raise RuntimeError(f"K8 at E = {e} took its {figs['route']} kernel")
        run["k8"][e] = {"ms": lines[f"extended_pbs_e{e}"]["kernel_ms"],
                        "bound": k8_bound(msed[:, :-1], acc0, p.pbs_level, p.pbs_base_log)}
        if e == 1:
            k2 = server.sample_extract(kernels.blind_rotate(
                msed[:, :-1], msed[:, -1], lut_b.contiguous(), key, dp, p.pbs_base_log,
                p.pbs_level))
            lines["extended_pbs_e1"]["vs_k2_exact_words_differing"] = int((out != k2).sum())
            wrong += lines["extended_pbs_e1"]["vs_k2_exact_words_differing"]
    torch.cuda.empty_cache()
    line = {"params": "V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 widths", "n": n,
            "k": k, "N": n_poly, "glwe_ks_base_log": base_log, "glwe_ks_level": levels,
            **lines, "wrong": wrong}
    return {"line": line, "wrong": wrong, "run": run}


def research_vs_plain(kernels, server, torus, run, p, seed: int, errs: dict) -> dict:
    """K7 at both signs on phase 33's B = 512 inputs and keys against its
    plain version; K1 at the shrinking and CM keyswitch shapes on phase 33's
    inputs against the plain keyswitch; K8's lazy kernel at E = 1, 2, 4, 8
    (also at each of its slots a block, SB <= E, through its C entry; the
    (E, SB) held go into out["k8_slots_held"]), its
    generic kernel at l = 2 (K8_GENERIC_DECOMP), K2's cluster kernel at
    the CM shapes k+1 in CM_PLAIN_K1 and its generic kernel at k+1 = 4 (the
    kernel the cluster kernel replaced there) at B = CHECK_BATCH over
    RESEARCH_PLAIN_STEPS steps of a random key against their plain
    versions, each wrapper call checked to have run the kernel it names;
    K2's CMux entry there (its cluster route; its generic kernel where its
    block fits, k+1 <= 4) on a random GGSW and operands, and phase 33's CM CMux and external
    product words against server.cmux.  Times and bounds."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    base_log, levels = run["k7"]["decomp"]
    out = {"k7": {}, "k8": {}}
    for tag, add_sum in (("glwe", False), ("fast", True)):
        glwes, key, got = run["k7"][tag]
        kd, kdp = key.data, key.dp
        want = server.glwe_keyswitch_sum(glwes, kd, kdp, base_log, levels, add_sum)
        errs[f"k7_{tag}_keyswitch_b{glwes.shape[0]}"] = max_abs_err(got, want)
        # the cluster kernel at B = 3 through the wrapper, and the first
        # kernel (the first design) at B = 3 and 512, against the plain sum
        before = kernels.glwe_keyswitch.cluster_launches
        small = glwes[:3].contiguous()
        errs[f"k7_{tag}_keyswitch_b3"] = max_abs_err(
            kernels.glwe_keyswitch(small, kd, kdp, base_log, levels, add_sum),
            server.glwe_keyswitch_sum(small, kd, kdp, base_log, levels, add_sum))
        if kernels.glwe_keyswitch.cluster_launches != before + 1:
            raise RuntimeError(f"K7 ({tag}) at B = 3 did not run its cluster kernel")
        errs[f"k7_{tag}_first_kernel_b3"] = max_abs_err(
            first_glwe_keyswitch(kernels, small, kd, kdp, base_log, levels, add_sum),
            server.glwe_keyswitch_sum(small, kd, kdp, base_log, levels, add_sum))
        first = lambda: first_glwe_keyswitch(kernels, glwes, kd, kdp, base_log,  # noqa: E731
                                             levels, add_sum)
        errs[f"k7_{tag}_first_kernel_b{glwes.shape[0]}"] = max_abs_err(first(), want)
        times = in_turns({"first": first,
                          "cluster": lambda: kernels.glwe_keyswitch(glwes, kd, kdp, base_log,
                                                                    levels, add_sum)}, 5)
        words = standard_glwe_key(kd, kdp)
        lib = int_mm_glwe_keyswitch(glwes, words, base_log, levels, add_sum)
        out["k7"][tag] = {
            "ms": min(t for t, _ in times["cluster"]),
            "first_kernel_ms": min(t for t, _ in times["first"]), "in_turns_ms": times,
            "plain_ms": cuda_ms(lambda: server.glwe_keyswitch_sum(glwes, kd, kdp, base_log,
                                                                  levels, add_sum), 2),
            "library_ms": cuda_ms(lambda: int_mm_glwe_keyswitch(glwes, words, base_log,
                                                                levels, add_sum), 2),
            "library_words_differing": max_abs_err(lib, want),
            "library_call": (f"{sum(8 - t for t in range((base_log + 8) // 8))} int8 "
                             f"torch._int_mm GEMMs of the digits by the key's negacyclic "
                             f"Toeplitz (balanced byte limbs)"),
            "bound": k7_bound(glwes, kd, got),
            **kernels.glwe_keyswitch_figures(kd.shape[0], kd.shape[2], glwes.shape[2], levels,
                                             base_log),
            "first_rows_a_chunk": kernels.glwe_keyswitch_rows(kd.shape[2], glwes.shape[2]),
            "shape": list(glwes.shape) + list(kd.shape[:3])}
        del words, lib
    ks_base_log, ks_level = p.ks_base_log, p.ks_level
    for tag, ct, key_words, key in (
            ("shrinking", torch.cat([run["shrinking"][0][:, p.lwe_dimension:-1],
                                     run["shrinking"][0][:, -1:]], dim=1),
             torus.from_u64(run["shrinking"][1].ksk.data, dev), run["shrinking"][1].key),
            ("cm", torch.cat([run["cm_keyswitch"][0][:, :-CM_SLOTS],
                              run["cm_keyswitch"][0][:, :1] * 0], dim=1),
             torus.from_u64(run["cm_keyswitch"][1].data, dev), run["cm_keyswitch"][1].key)):
        got = kernels.keyswitch(ct, key, ks_base_log, ks_level)
        errs[f"k1_{tag}_keyswitch_b{ct.shape[0]}"] = max_abs_err(
            got, server.keyswitch(ct, key_words, ks_base_log, ks_level))
        out[f"k1_{tag}"] = {
            "ms": cuda_ms(lambda: kernels.keyswitch(ct, key, ks_base_log, ks_level), 10),
            "plain_ms": cuda_ms(lambda: server.keyswitch(ct, key_words, ks_base_log, ks_level),
                                3),
            "library_ms": cuda_ms(lambda: int_mm_keyswitch(ct, key_words, ks_base_log,
                                                           ks_level), 5),
            "library_words_differing": max_abs_err(
                int_mm_keyswitch(ct, key_words, ks_base_log, ks_level), got),
            "bound": k1_bound(ct, key_words, got, ks_base_log),
            "shape": [ct.shape[0], ct.shape[1] - 1, ks_level, key_words.shape[2]]}
    # the rotations on a random key at B = CHECK_BATCH over RESEARCH_PLAIN_STEPS steps
    n_poly, k = p.polynomial_size, p.glwe_dimension
    dp = run["dp"]
    b, steps = CHECK_BATCH, RESEARCH_PLAIN_STEPS

    def held(tag, fn, plain, counter=None, must=None):
        """fn() against plain(), the words differing into errs[tag]; where
        counter, fn must add one to that launch count."""
        before = getattr(*counter) if counter else 0
        errs[tag] = max_abs_err(fn(), plain())
        if counter and getattr(*counter) - before != must:
            raise RuntimeError(f"{tag} did not run the kernel it names")

    out["k8_slots_held"] = []
    for e in EXT_PLAIN_FACTORS:
        rkey = random_ntt_key((steps, p.pbs_level, k + 1, k + 1), dp, gen)
        mask = torch.from_numpy(rng.integers(0, 2 * n_poly * e, (b, steps))).to(dev)
        acc = torus.from_u64(rng.integers(0, 1 << 64, (b, e, k + 1, n_poly), dtype=np.uint64),
                             dev)
        args = (rkey, dp, p.pbs_base_log, p.pbs_level)
        want = server.blind_rotate_extended(mask, acc, *args)
        held(f"k8_e{e}_random_key_b{b}", lambda: kernels.blind_rotate_extended(mask, acc, *args),
             lambda: want, (kernels.blind_rotate_extended, "lazy_launches"), 1)
        # every slots a block the wrapper may pick at this E (it picks by
        # the batch), on the same inputs: at SB < E the gather reads other
        # blocks' slots through distributed shared memory
        for sb in kernels.K8_SLOTS:
            if sb <= e:
                errs[f"k8_sb{sb}_e{e}_random_key_b{b}"] = max_abs_err(
                    extended_lazy_slots(kernels, acc, mask, *args, sb), want)
                out["k8_slots_held"].append((e, sb))
        out["k8"][e] = {
            "ms": cuda_ms(lambda: kernels.blind_rotate_extended(mask, acc, *args), 3),
            "plain_ms": cuda_ms(lambda: server.blind_rotate_extended(mask, acc, *args), 1),
            "bound": k8_bound(mask, acc, p.pbs_level, p.pbs_base_log)}
    # K8's generic kernel at a shape still routed to it (l = 2), E = 2
    g_base, g_levels = K8_GENERIC_DECOMP
    if kernels.extended_route(k + 1, n_poly, g_levels, g_base) != "generic":
        raise RuntimeError("K8 at l = 2 no longer routes to its generic kernel")
    rkey = random_ntt_key((steps, g_levels, k + 1, k + 1), dp, gen)
    mask = torch.from_numpy(rng.integers(0, 4 * n_poly, (b, steps))).to(dev)
    acc = torus.from_u64(rng.integers(0, 1 << 64, (b, 2, k + 1, n_poly), dtype=np.uint64), dev)
    args = (rkey, dp, g_base, g_levels)
    held(f"k8_generic_l{g_levels}_e2_random_key_b{b}",
         lambda: kernels.blind_rotate_extended(mask, acc, *args),
         lambda: server.blind_rotate_extended(mask, acc, *args),
         (kernels.blind_rotate_extended, "lazy_launches"), 0)
    out["k8_generic"] = {"ms": cuda_ms(lambda: kernels.blind_rotate_extended(mask, acc, *args), 3),
                         "bound": k8_bound(mask, acc, g_levels, g_base),
                         "shape": [b, 2, steps, g_levels, k + 1, n_poly]}
    # K2's cluster kernel at the CM shapes; its generic kernel at k+1 = 4
    out["k2_cm"] = {}
    for k1 in CM_PLAIN_K1:
        rkey = random_ntt_key((steps, p.pbs_level, k1, k1), dp, gen)
        mask = torch.from_numpy(rng.integers(0, 2 * n_poly, (b, steps))).to(dev)
        acc = torus.from_u64(rng.integers(0, 1 << 64, (b, k1, n_poly), dtype=np.uint64), dev)
        args = (rkey, dp, p.pbs_base_log, p.pbs_level)
        held(f"k2_cm_cluster_k{k1}_random_key_b{b}",
             lambda: kernels.rotate_accumulator(acc, mask, *args),
             lambda: server.rotate_accumulator(acc, mask, *args),
             (kernels.blind_rotate, "cluster_launches"), 1)
        out["k2_cm"][k1] = {
            "ms": cuda_ms(lambda: kernels.rotate_accumulator(acc, mask, *args), 3),
            "plain_ms": cuda_ms(lambda: server.rotate_accumulator(acc, mask, *args), 1),
            "bound": k2_bound(mask, acc, p.pbs_level, p.pbs_base_log, EXACT_PRIMES),
            "shape": [b, steps, k1, n_poly]}
        if k1 == k + CM_SLOTS:
            held(f"k2_generic_cm_k{k1}_random_key_b{b}",
                 lambda: generic_exact_rotate(kernels, acc, mask, *args),
                 lambda: server.rotate_accumulator(acc, mask, *args))
            out["k2_cm"][k1]["generic_ms"] = cuda_ms(
                lambda: generic_exact_rotate(kernels, acc, mask, *args), 3)
        # K2's CMux entry there (its cluster route) on a random GGSW and
        # random operands; its generic kernel at k+1 = 4
        ggsw = random_ntt_key((p.pbs_level, k1, k1), dp, gen)
        ct1 = torus.from_u64(rng.integers(0, 1 << 64, (b, k1, n_poly), dtype=np.uint64), dev)
        cargs = (ggsw, dp, p.pbs_base_log, p.pbs_level)
        held(f"cmux_cluster_k{k1}_random_b{b}", lambda: kernels.cmux(acc, ct1, *cargs),
             lambda: server.cmux(acc, ct1, *cargs), (kernels.cmux, "cluster_launches"), 1)
        if (k1 <= kernels.GENERIC_MAX_K1
                and kernels.exact_smem_bytes(k1, n_poly, p.pbs_level) <= kernels.SMEM_LIMIT):
            held(f"cmux_generic_k{k1}_random_b{b}", lambda: generic_cmux(kernels, acc, ct1, *cargs),
                 lambda: server.cmux(acc, ct1, *cargs))
    # phase 33's CM CMux and external product outputs against server.cmux
    for c_dim, fig in run["cm_cmux"].items():
        errs[f"cm_cmux_c{c_dim}_b{RESEARCH_PBS_BATCH}"] = fig["vs_plain_words_differing"]
        if "external_product" in fig:
            errs[f"cm_external_product_c{c_dim}_b{RESEARCH_PBS_BATCH}"] = (
                fig["external_product"]["vs_plain_words_differing"])
    return out


# K2 at the TEST shapes (N = 512): the rotation (l = 1, base 2^23, 16
# steps: WoPBS's and AES's PBS) at SMALL_ROTATION_BATCHES, the CMux chain of
# vertical packing (l = 4, base 2^6, 8 steps) on SMALL_CHAIN_SETS GGSW sets
# at SMALL_CHAIN_BATCHES; every timing over SMALL_REPS launches
SMALL_ROTATION = (16, 1, 23)  # steps, l, base_log
SMALL_CHAIN = (8, 4, 6)
SMALL_ROTATION_BATCHES = (4, 128, 512)
SMALL_CHAIN_BATCHES = (1, 64)
SMALL_CHAIN_SETS = 3
SMALL_REPS = 10


def chain_bound(a_cols, acc, sets, index, levels: int, base_log: int) -> dict:
    """Least time for K2's CMux chain: the steps' products as k2_bound
    counts them (four primes), against the GGSW sets that index names
    (each read once; the others are not read), the rotations, the index,
    and the accumulators in and out moved once."""
    ops = k2_bound(a_cols, acc, levels, base_log, EXACT_PRIMES)
    t_ops = min(ops["ntt_ms"], ops["four_step_ms"])
    t_bytes = ((4 * sets[0].numel() * len(set(index.tolist())) + 4 * a_cols.numel()
                + 4 * a_cols.shape[0] + 2 * 8 * acc.numel()) / HBM_BYTES_PER_S * 1e3)
    return {"ms": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ntt_ms": ops["ntt_ms"], "four_step_ms": ops["four_step_ms"]}


def in_turns(fns: dict, reps: int) -> dict:
    """launch_ms of each fn, taken in turns (a, b, b, a): name -> [(ms,
    host ms), (ms, host ms)]."""
    order = list(fns) + list(reversed(list(fns)))
    out = {name: [] for name in fns}
    for name in order:
        out[name].append(launch_ms(fns[name], reps))
    return out


def small_n_vs_plain(kernels, server, torus, seed: int, errs: dict) -> dict:
    """K2's small-N cluster kernel (csrc/blind_rotate_cluster.cu
    blind_rotate_cluster_small_kernel) at the TEST shapes on random keys,
    in turns against the generic kernel's C entry (the first design, the
    yardstick), each held against its plain version: the rotation through
    kernels.rotate_accumulator at B = 4, 128, 512 (server.rotate_accumulator);
    the CMux chain through kernels.cmux_chain on three GGSW sets and a
    ragged key_index at B = 1, 64 (server.cmux_chain; the generic kernel
    runs the same steps on set 0, and the step entry, which vertical
    packing ran before, one of them at B = 1)."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import ntt

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    n_poly, k1 = 512, 2
    dp = ntt.device_plan(ntt.make_plan(n_poly, EXACT_PRIMES), "cuda")
    out = {"rotation": {}, "chain": {}}
    steps, levels, base_log = SMALL_ROTATION
    key = random_ntt_key((steps, levels, k1, k1), dp, gen)
    for b in SMALL_ROTATION_BATCHES:
        acc = torus.from_u64(rng.integers(0, 1 << 64, (b, k1, n_poly), dtype=np.uint64), dev)
        mask = torch.from_numpy(rng.integers(0, 2 * n_poly, (b, steps))).to(dev)
        before = kernels.blind_rotate.cluster_launches
        got = kernels.rotate_accumulator(acc, mask, key, dp, base_log, levels)
        if kernels.blind_rotate.cluster_launches != before + 1:
            raise RuntimeError("the TEST rotation shape did not route to the cluster kernel")
        t0 = time.perf_counter()
        want = server.rotate_accumulator(acc, mask, key, dp, base_log, levels)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs[f"k2_small_rotation_b{b}"] = max_abs_err(got, want)
        errs[f"k2_generic_test_shape_rotation_b{b}"] = max_abs_err(
            generic_exact_rotate(kernels, acc, mask, key, dp, base_log, levels), want)
        t = in_turns({"cluster": lambda: kernels.rotate_accumulator(acc, mask, key, dp, base_log,
                                                                    levels),
                      "generic": lambda: generic_exact_rotate(kernels, acc, mask, key, dp,
                                                              base_log, levels)}, SMALL_REPS)
        bound = k2_bound(mask, acc, levels, base_log, EXACT_PRIMES)
        out["rotation"][f"b{b}"] = {
            "ms": min(x[0] for x in t["cluster"]), "host_ms": min(x[1] for x in t["cluster"]),
            "generic_ms": min(x[0] for x in t["generic"]),
            "generic_host_ms": min(x[1] for x in t["generic"]), "turns": t,
            "plain_ms": plain_ms, "bound_ms": bound["ms"], "bound_by": bound["by"],
            "shape": [b, steps, k1, n_poly, levels, base_log]}
    # the kernel's other instances (l = 2, 3; k+1 = 3, 4 at l = 1), which no
    # set runs: held only (k+1 = 5, 1_1's, in param_sets_vs_plain)
    for k1_o, levels, base_log in ((k1, 2, 15), (k1, 3, 10), (3, 1, 23), (4, 1, 23)):
        key = random_ntt_key((4, levels, k1_o, k1_o), dp, gen)
        acc = torus.from_u64(rng.integers(0, 1 << 64, (3, k1_o, n_poly), dtype=np.uint64), dev)
        mask = torch.from_numpy(rng.integers(0, 2 * n_poly, (3, 4))).to(dev)
        tag = f"l{levels}" if k1_o == k1 else f"k{k1_o}"
        errs[f"k2_small_rotation_{tag}_b3"] = max_abs_err(
            kernels.rotate_accumulator(acc, mask, key, dp, base_log, levels),
            server.rotate_accumulator(acc, mask, key, dp, base_log, levels))
    steps, levels, base_log = SMALL_CHAIN
    sets = random_ntt_key((SMALL_CHAIN_SETS, steps + 1, levels, k1, k1), dp, gen)[:, 1:]
    for b in SMALL_CHAIN_BATCHES:
        acc = torus.from_u64(rng.integers(0, 1 << 64, (b, k1, n_poly), dtype=np.uint64), dev)
        cols = torch.from_numpy(rng.integers(0, 2 * n_poly, (b, steps))).to(dev)
        index = torch.from_numpy(rng.integers(0, SMALL_CHAIN_SETS, (b,)))
        index[0] = SMALL_CHAIN_SETS - 1
        got = kernels.cmux_chain(acc, cols, sets, index, dp, base_log, levels)
        t0 = time.perf_counter()
        want = server.cmux_chain(acc, cols, sets, index, dp, base_log, levels)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs[f"cmux_chain_b{b}"] = max_abs_err(got, want)
        one = sets[0].contiguous()
        errs[f"k2_generic_test_shape_chain_b{b}"] = max_abs_err(
            generic_exact_rotate(kernels, acc, cols, one, dp, base_log, levels),
            server.rotate_accumulator(acc, cols, one, dp, base_log, levels))
        step_acc = acc[:1].contiguous()
        errs[f"k2_step_test_shape_b{b}"] = max_abs_err(
            kernels.cmux_step(step_acc.clone(), cols[:1, 0], one[0], dp, base_log, levels),
            server.cmux_step(step_acc, cols[:1, 0], one[0], dp, base_log, levels))
        t = in_turns({"chain": lambda: kernels.cmux_chain(acc, cols, sets, index, dp, base_log,
                                                          levels),
                      "generic": lambda: generic_exact_rotate(kernels, acc, cols, one, dp,
                                                              base_log, levels)}, SMALL_REPS)
        step_ms, step_host_ms = launch_ms(lambda: kernels.cmux_step(
            step_acc, cols[:1, 0], one[0], dp, base_log, levels), SMALL_REPS)
        bound = chain_bound(cols, acc, sets, index, levels, base_log)
        out["chain"][f"b{b}"] = {
            "ms": min(x[0] for x in t["chain"]), "host_ms": min(x[1] for x in t["chain"]),
            "generic_ms": min(x[0] for x in t["generic"]),
            "generic_host_ms": min(x[1] for x in t["generic"]), "turns": t,
            "step_entry_b1_ms": step_ms, "step_entry_b1_host_ms": step_host_ms,
            "plain_ms": plain_ms, "bound_ms": bound["ms"], "bound_by": bound["by"],
            "bound_bytes_ms": bound["bytes_ms"],
            "shape": [b, steps, k1, n_poly, levels, base_log], "sets": SMALL_CHAIN_SETS,
            "sets_read": len(set(index.tolist()))}
    return out


def test_shape_figures(kernels, server, torus, shapes: dict, seed: int, errs: dict) -> dict:
    """K2 at the TEST shapes (N = 512) as phases 28-29 launched it: for each
    recorded (entry, route, B, steps, k+1, N, l, base_log), its launches,
    and on a random key and random inputs of that shape (one GGSW set a
    chain) the route's kernel and the generic kernel's C entry in turns
    (SMALL_REPS launches, CUDA-event ms and the host's ms a launch), the
    bound and one check of each against the plain version; the
    launch-weighted sums."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import ntt

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    out = {"rotation": [], "chain": [], "step_entry": []}
    for (entry, route, b, steps, k1, n_poly, levels, base_log), count in sorted(shapes.items()):
        if n_poly != 512:
            continue
        dp = ntt.device_plan(ntt.make_plan(n_poly, EXACT_PRIMES), "cuda")
        key = random_ntt_key((steps, levels, k1, k1), dp, gen)
        mask = torch.from_numpy(rng.integers(0, 2 * n_poly, (b, steps))).to(dev)
        acc = torus.from_u64(rng.integers(0, 1 << 64, (b, k1, n_poly), dtype=np.uint64), dev)
        zero = torch.zeros(b, dtype=torch.int64)
        if entry == "cmux_step":
            fn = lambda: kernels.cmux_step(acc.clone(), mask[:, 0], key[0], dp,  # noqa: E731
                                           base_log, levels)
            want = server.cmux_step(acc, mask[:, 0], key[0], dp, base_log, levels)
        elif entry == "cmux_chain":
            fn = lambda: kernels.cmux_chain(acc, mask, key[None], zero, dp,  # noqa: E731
                                            base_log, levels)
            want = server.rotate_accumulator(acc, mask, key, dp, base_log, levels)
        else:
            fn = lambda: kernels.rotate_accumulator(acc, mask, key, dp,  # noqa: E731
                                                    base_log, levels)
            want = server.rotate_accumulator(acc, mask, key, dp, base_log, levels)
        generic = lambda: generic_exact_rotate(kernels, acc, mask, key, dp,  # noqa: E731
                                               base_log, levels)
        tag = f"{entry}_{route}_b{b}_l{levels}"
        errs[f"k2_test_shape_{tag}"] = max_abs_err(fn(), want)
        if entry != "cmux_step":
            errs[f"k2_generic_test_shape_{tag}"] = max_abs_err(generic(), want)
        t = in_turns({"route": fn, "generic": generic}, SMALL_REPS)
        bound = k2_bound(mask, acc, levels, base_log, EXACT_PRIMES)
        rows = out["rotation" if entry == "blind_rotate" else
                   "chain" if entry == "cmux_chain" else "step_entry"]
        rows.append({"entry": entry, "route": route, "batch": b, "steps": steps, "k1": k1,
                     "N": n_poly, "levels": levels, "base_log": base_log, "launches": count,
                     "ms": min(x[0] for x in t["route"]),
                     "host_ms": min(x[1] for x in t["route"]),
                     "generic_ms": min(x[0] for x in t["generic"]),
                     "generic_host_ms": min(x[1] for x in t["generic"]),
                     "bound_ms": bound["ms"], "bound_by": bound["by"]})
    for rows in out.values():
        rows.append({"launch_weighted": {
            "launches": sum(r["launches"] for r in rows),
            "ms": sum(r["launches"] * r["ms"] for r in rows),
            "generic_ms": sum(r["launches"] * r["generic_ms"] for r in rows),
            "bound_ms": sum(r["launches"] * r["bound_ms"] for r in rows)}})
    return out


class RotationShapes:
    """Records the shape of every exact rotation K2's wrappers launch
    (kernels._launch_blind_rotate, which blind_rotate's exact mode,
    rotate_accumulator, cmux_step and cmux_chain call, each naming itself
    as the launch's entry) while in a with block: (entry, route, B, steps,
    k+1, N, l, base_log) -> launches.  The wrappers' own counts are
    untouched."""

    def __init__(self, kernels):
        self.kernels, self.shapes = kernels, {}

    def _add(self, shape) -> None:
        self.shapes[shape] = self.shapes.get(shape, 0) + 1

    def __enter__(self):
        launch = self.original = self.kernels._launch_blind_rotate

        def recorded(acc, mask32, bsk_ntt, dp, base_log, levels, entry, key_index=None):
            route = launch(acc, mask32, bsk_ntt, dp, base_log, levels, entry, key_index)
            self._add((entry, route, acc.shape[0], mask32.shape[1], acc.shape[1],
                       acc.shape[2], levels, base_log))
            return route

        self.kernels._launch_blind_rotate = recorded
        return self

    def __exit__(self, *exc):
        self.kernels._launch_blind_rotate = self.original
        return False


def param_sets_table_entries(s18: dict, by_path, errs: dict, ptxas_kernels: dict) -> list:
    """The {"kernels": [...]} rows of phase 32's new routes, from
    param_sets_vs_plain's figures (s18) and the phase's launches (by_path:
    s14_by_path): K2's small-N cluster kernel at 1_1 and K3's cluster kernel
    at the GPU GROUP_2 and GROUP_3 sets, each at B = PARAM_SETS_BATCH with
    its B = CHECK_BATCH figures beside."""
    big, small = f"b{PARAM_SETS_BATCH}", f"b{CHECK_BATCH}"
    none = "none: no PyTorch call computes an exact wrapping-u64 negacyclic product"

    def row(fig: dict) -> dict:
        at = fig[big]
        return {"ms": at["ms"], "host_ms": at["host_ms"], "generic_kernel_ms": at["generic_ms"],
                "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
                "bound_by": at["bound_by"], "library_ms": None, "library_call": none,
                "bound_primes": EXACT_PRIMES, "bound_bytes_ms": at["bound_bytes_ms"],
                "bound_ntt_int32_ms": at["bound_ntt_int32_ms"],
                f"{small}_ms": fig[small]["ms"], f"{small}_host_ms": fig[small]["host_ms"],
                f"{small}_generic_kernel_ms": fig[small]["generic_ms"],
                f"{small}_plain_ms": fig[small]["plain_ms"],
                f"{small}_bound_ms": fig[small]["bound_ms"],
                "shared_memory_bytes": fig["shared_memory_bytes"],
                "blocks_per_sm": fig["blocks_per_sm"], "active_clusters": fig["active_clusters"],
                "shape": at["shape"]}

    k2_paths = by_path("blind_rotate_cluster", ("param_sets_1_1",))
    k3_paths = by_path("blind_rotate_multibit_cluster",
                       ("param_sets_gpu_group_2", "param_sets_gpu_group_3"))
    k2_regs = small_regs(ptxas_kernels, 1, 5)
    k3_regs = {tag: multibit_cluster_regs(ptxas_kernels, n, lev, g)
               for tag, (n, lev, g) in (("gpu_group_2", (4096, 1, 2)),
                                        ("gpu_group_3", (2048, 2, 3)))}
    return [
        {"name": "blind_rotate_cluster_small_1_1", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate_cluster.cu",
         "replaces": "tfhe_tpu/ops/pallas_ntt.py:794",
         "kernel": "blind_rotate_cluster_small_kernel<5, 1> (K2's exact rotation at 1_1, "
                   "k+1 = 5, N = 512, l = 1: a cluster of 4 blocks of 128 threads a "
                   "ciphertext, one a CRT prime, one key buffer a block)",
         "launches": sum(k2_paths.values()), "launches_by_path": k2_paths,
         "max_abs_err": max(v for k, v in errs.items() if k.startswith("k2_small_k5")),
         **row(s18["1_1"]), "registers": k2_regs.get("registers"),
         "spill_store_bytes": k2_regs.get("spill_store_bytes")},
        {"name": "blind_rotate_multibit_cluster", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate_multibit_cluster.cu",
         "replaces": "tfhe_tpu/ops/server.py:425",
         "kernel": "blind_rotate_multibit_cluster_kernel (K3's exact rotation at the GPU "
                   "multi-bit GROUP_2 and GROUP_3 sets: a cluster of 4 blocks of 256 threads a "
                   "ciphertext, one a CRT prime, two blocks an SM; the row's figures are "
                   "GROUP_2's, GROUP_3's in gpu_group_3)",
         "launches": sum(k3_paths.values()), "launches_by_path": k3_paths,
         "max_abs_err": max(v for k, v in errs.items() if k.startswith(("k3_cluster",
                                                                        "k3_group_3"))),
         **row(s18["gpu_group_2"]), "registers": k3_regs["gpu_group_2"].get("registers"),
         "spill_store_bytes": k3_regs["gpu_group_2"].get("spill_store_bytes"),
         "gpu_group_3": {**row(s18["gpu_group_3"]), **k3_regs["gpu_group_3"]}}]


def research_table_entries(kernels, rp_run, s15, errs: dict, ptxas_kernels: dict, p) -> list:
    """The kernel table's entries of phase 33: K7, K8 (its lazy kernel; its
    generic kernel's figures), K2's cluster kernel at the CM shape (with its
    generic kernel's time there), K1 at the CM and shrinking shapes, each
    with its launches on phase 33's steps, its time, the plain version's
    and the bound."""
    rp_l = rp_run["line"]

    def rp_launches(counter: str, steps=RESEARCH_STEPS) -> dict:
        return {t: rp_l[t]["launches"].get(counter, 0) for t in steps
                if rp_l[t]["launches"].get(counter, 0)}

    def with_regs(entry: dict, kernel: str) -> dict:
        regs = ptxas_of(ptxas_kernels, kernel)
        return {**entry, "registers": regs.get("registers"),
                "spill_store_bytes": regs.get("spill_store_bytes")}

    no_library = "none: no PyTorch call computes an exact wrapping-u64 negacyclic product"
    k7g, k7f = s15["k7"]["glwe"], s15["k7"]["fast"]
    k8_run, e_max = rp_run["run"]["k8"], max(EXT_FACTORS)
    cm_run, c4_run = rp_run["run"]["cm_bootstrap"], rp_run["run"]["cm_bootstrap_c4"]
    cm_k1 = p.glwe_dimension + CM_SLOTS
    cm_launches = rp_launches("blind_rotate", ("cm_bootstrap", "cm_bootstrap_c4",
                                               "cm_bootstrap_c1"))
    return [
        with_regs({
            "name": "glwe_keyswitch", "route": "cuda",
            "source": "tfhe_tpu_torch/csrc/glwe_keyswitch.cu",
            "replaces": "tfhe_tpu/ops/server.py:862",
            "also_replaces": "tfhe_tpu/core/experimental.py:218",
            "kernel": "glwe_keyswitch_cluster_kernel (a cluster of four blocks a GLWE, one a "
                      "CRT prime, lazy Shoup passes, Garner through distributed shared "
                      "memory; add_sum for the fast keyswitch)",
            "launches": sum(rp_launches("glwe_keyswitch_cluster").values()),
            "launches_by_path": rp_launches("glwe_keyswitch_cluster"),
            "first_kernel_launches_by_path": {
                t: n - rp_launches("glwe_keyswitch_cluster").get(t, 0)
                for t, n in rp_launches("glwe_keyswitch").items()},
            "max_abs_err": max(v for k_, v in errs.items() if k_.startswith("k7")),
            "words_differing": {k_: v for k_, v in errs.items() if k_.startswith("k7")},
            "ms": k7g["ms"], "first_kernel_ms": k7g["first_kernel_ms"],
            "in_turns_ms": k7g["in_turns_ms"], "plain_ms": k7g["plain_ms"],
            "bound_ms": k7g["bound"]["ms"], "bound_by": k7g["bound"]["by"],
            "bound_bytes_ms": k7g["bound"]["bytes_ms"],
            "bound_ntt_int32_ms": k7g["bound"]["ntt_int32_ms"],
            "library_ms": k7g["library_ms"], "library_call": k7g["library_call"],
            "library_words_differing": k7g["library_words_differing"],
            "shared_memory_bytes": k7g["shared_memory_bytes"],
            "active_clusters": k7g["active_clusters"], "shape": k7g["shape"],
            "first_kernel": ptxas_of(ptxas_kernels, "glwe_keyswitch_kernel"),
            "fast_keyswitch": {key_: k7f[key_] for key_ in (
                "ms", "first_kernel_ms", "in_turns_ms", "plain_ms", "library_ms",
                "library_words_differing", "shared_memory_bytes", "active_clusters", "shape")}
            | {"bound_ms": k7f["bound"]["ms"], "bound_by": k7f["bound"]["by"]}},
            "glwe_keyswitch_cluster_kernel"),
        with_regs({
            "name": "blind_rotate_extended", "route": "cuda",
            "source": "tfhe_tpu_torch/csrc/blind_rotate_extended.cu",
            "replaces": "tfhe_tpu/core/experimental.py:306",
            "kernel": "blind_rotate_extended_lazy_kernel (K2's six lazy passes; a cluster of "
                      "E / SB blocks of SB slots a ciphertext)",
            "launches": sum(rp_launches("blind_rotate_extended_lazy").values()),
            "launches_by_path": rp_launches("blind_rotate_extended_lazy"),
            "max_abs_err": max(v for k_, v in errs.items() if k_.startswith("k8")),
            "words_differing_from_k2_at_e1": rp_l["extended_pbs_e1"][
                "vs_k2_exact_words_differing"],
            "ms": k8_run[e_max]["ms"], "ext_factor": e_max,
            "plain_ms": s15["k8"][e_max]["plain_ms"], "plain_batch": CHECK_BATCH,
            "plain_steps": RESEARCH_PLAIN_STEPS,
            "bound_ms": k8_run[e_max]["bound"]["ms"], "bound_by": k8_run[e_max]["bound"]["by"],
            "library_ms": None, "library_call": no_library,
            "by_ext_factor": {e: {"ms": k8_run[e]["ms"], "bound_ms": k8_run[e]["bound"]["ms"],
                                  **{k_: rp_l[f"extended_pbs_e{e}"][k_] for k_ in (
                                      "slots_per_block", "cluster_blocks",
                                      "shared_memory_bytes",
                                      "active_clusters")}}
                              for e in EXT_FACTORS},
            "random_key_by_ext_factor": {e: {"ms": s15["k8"][e]["ms"],
                                             "bound_ms": s15["k8"][e]["bound"]["ms"],
                                             "plain_ms": s15["k8"][e]["plain_ms"]}
                                         for e in EXT_PLAIN_FACTORS},
            "generic_kernel": {
                "kernel": "blind_rotate_extended_kernel (the first design; shapes the lazy "
                          "kernel does not take)",
                "ms": s15["k8_generic"]["ms"], "bound_ms": s15["k8_generic"]["bound"]["ms"],
                "shape": s15["k8_generic"]["shape"],
                **{k_: v for k_, v in ptxas_of(ptxas_kernels,
                                               "blind_rotate_extended_kernel").items()
                   if k_ in ("registers", "spill_store_bytes")}},
            "shape": [RESEARCH_PBS_BATCH, e_max, p.lwe_dimension, p.glwe_dimension + 1,
                      p.polynomial_size]},
            "blind_rotate_extended_lazy_kernel"),
        {
            "name": "blind_rotate_cm", "route": "cuda",
            "source": "tfhe_tpu_torch/csrc/blind_rotate_cluster.cu",
            "replaces": "tfhe_tpu/core/cm.py:299",
            "kernel": f"blind_rotate_cluster_kernel (K2's cluster kernel at k+1 = "
                      f"{p.glwe_dimension + CM_SLOTS}, N = {p.polynomial_size}: four blocks a "
                      f"ciphertext, one a CRT prime; the lazy kernel at C = 1)",
            "launches": sum(cm_launches.values()), "launches_by_path": cm_launches,
            "cluster_launches_by_path": rp_launches("blind_rotate_cluster"),
            "lazy_launches_by_path": rp_launches("blind_rotate_exact_lazy"),
            "max_abs_err": max(v for k_, v in errs.items() if k_.startswith(
                ("k2_cm", "k2_generic_cm"))),
            "ms": cm_run["ms"], "plain_ms": s15["k2_cm"][cm_k1]["plain_ms"],
            "plain_batch": CHECK_BATCH, "plain_steps": RESEARCH_PLAIN_STEPS,
            "generic_kernel_ms": cm_run["generic_ms"],
            "k1_3": cm_run["k1_3"],
            "c4": {"ms": c4_run["ms"], "bound_ms": c4_run["bound"]["ms"],
                   "shape": c4_run["shape"]},
            "random_key_by_k1": {k1: {key_: v for key_, v in row.items() if key_ != "bound"}
                                 | {"bound_ms": row["bound"]["ms"]}
                                 for k1, row in s15["k2_cm"].items()},
            "bound_ms": cm_run["bound"]["ms"], "bound_by": cm_run["bound"]["by"],
            "library_ms": None, "library_call": no_library,
            **{k_: rp_l["cm_bootstrap"][k_] for k_ in (
                "shared_memory_bytes", "blocks_per_sm", "active_clusters",
                "generic_kernel_would_need_bytes")},
            **cluster_regs(ptxas_kernels, p.glwe_dimension + CM_SLOTS, 1, 11),
            "generic_kernel_registers": ptxas_of(ptxas_kernels, "blind_rotate_kernel").get(
                "registers"),
            "shape": cm_run["shape"]},
        with_regs({
            "name": "keyswitch_cm", "route": "cuda",
            "source": "tfhe_tpu_torch/csrc/keyswitch.cu",
            "replaces": "tfhe_tpu/core/cm.py:123", "also_replaces": "tfhe_tpu/core/cm.py:402",
            "kernel": "keyswitch_imma_kernel on (mask, 0), n_out + C key columns",
            "launches": sum(rp_launches("keyswitch", ("cm_keyswitch", "cm_packing")).values()),
            "launches_by_path": rp_launches("keyswitch", ("cm_keyswitch", "cm_packing")),
            "max_abs_err": errs[f"k1_cm_keyswitch_b{RESEARCH_BATCH}"],
            "ms": s15["k1_cm"]["ms"], "plain_ms": s15["k1_cm"]["plain_ms"],
            "bound_ms": s15["k1_cm"]["bound"]["ms"], "bound_by": s15["k1_cm"]["bound"]["by"],
            "library_ms": s15["k1_cm"]["library_ms"],
            "library_call": "10 int8-limb torch._int_mm GEMMs (the TPU's formulation)",
            "library_words_differing": s15["k1_cm"]["library_words_differing"],
            "shape": s15["k1_cm"]["shape"]}, "keyswitch_imma_kernel"),
        with_regs({
            "name": "keyswitch_shrinking", "route": "cuda",
            "source": "tfhe_tpu_torch/csrc/keyswitch.cu",
            "replaces": "tfhe_tpu/core/experimental.py:126",
            "kernel": "keyswitch_imma_kernel on the tail (ct[:, n2:-1] | body)",
            "launches": sum(rp_launches("keyswitch", ("shrinking_keyswitch",)).values()),
            "launches_by_path": rp_launches("keyswitch", ("shrinking_keyswitch",)),
            "max_abs_err": errs[f"k1_shrinking_keyswitch_b{RESEARCH_BATCH}"],
            "ms": s15["k1_shrinking"]["ms"], "plain_ms": s15["k1_shrinking"]["plain_ms"],
            "bound_ms": s15["k1_shrinking"]["bound"]["ms"],
            "bound_by": s15["k1_shrinking"]["bound"]["by"],
            "library_ms": s15["k1_shrinking"]["library_ms"],
            "library_call": "10 int8-limb torch._int_mm GEMMs (the TPU's formulation)",
            "library_words_differing": s15["k1_shrinking"]["library_words_differing"],
            "shape": s15["k1_shrinking"]["shape"]}, "keyswitch_imma_kernel")]


# ---------------------------------------------------------------------------
# Phases 36-38: the core functions, multi-device (the batch mesh, the
# poly-sharded PBS on K9, the latency route) and the C API over the port
# ---------------------------------------------------------------------------

CORE_CHUNK = 8                # GGSWs a chunk, at the start, the middle and the end of the key
MESH_SLOTS = 4                # slots of cuda:0 in the repeated-device meshes
POLY_SLOTS = (1, 2, 4)        # D of the poly-sharded PBS
POLY_BATCHES = (1, CHECK_BATCH)
LATENCY_SLOTS = 4
# (D, B) at N = 2048, k+1 = 2: every shape the poly-sharded PBS runs
K9_SHAPES = tuple((d, b) for d in POLY_SLOTS for b in POLY_BATCHES)
K9_MAIN = (4, CHECK_BATCH)    # the kernels line's figures: the step entries'
K9_ROTATE_MAIN = (4, 1)       # and the fused entry's (the latency route's B = 1)
K9_STEPS_ROUTE = (4, 1)       # (D, B) of the step loop forced on the one-card mesh
K9_REPS = 20


def core_functions_phase(kernels, p, seed: int) -> dict:
    """At the 2_2 set on the card: BSK chunks (keygen.generate_lwe_bootstrap
    _key_chunk, the secret products on the card) against the same GGSWs of
    the whole key from a generator seeded alike; pseudo_random_lwe at 32
    bits against the u32 draw of its stream (and at 64 against the u64
    draw)."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.core import keygen as kg
    from tfhe_tpu_torch.shortint import oprf
    from tfhe_tpu_torch.utils.csprng import (ByteStream, DeterministicSeeder,
                                             EncryptionRandomGenerator, SecretRandomGenerator)

    sec = SecretRandomGenerator(seed)
    lwe = kg.generate_binary_lwe_secret_key(p.lwe_dimension, sec)
    glwe = kg.generate_binary_glwe_secret_key(p.glwe_dimension, p.polynomial_size, sec)

    def gen():
        return EncryptionRandomGenerator(seed + 1, DeterministicSeeder(seed + 2))

    t0 = time.perf_counter()
    whole = kg.generate_lwe_bootstrap_key(lwe, glwe, p.core.pbs_decomp, p.glwe_noise, gen())
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    chunks, wrong = {}, 0
    n = p.lwe_dimension
    for start, count in ((0, CORE_CHUNK), (n // 2, CORE_CHUNK), (n - CORE_CHUNK, CORE_CHUNK)):
        t0 = time.perf_counter()
        chunk = kg.generate_lwe_bootstrap_key_chunk(lwe, glwe, p.core.pbs_decomp, p.glwe_noise,
                                                    gen(), start, count)
        torch.cuda.synchronize()
        differing = int((chunk != whole.data[start:start + count]).sum())
        wrong += differing
        chunks[f"{start}_{count}"] = {"seconds": time.perf_counter() - t0,
                                      "words_differing": differing}
    stream = lambda: ByteStream(seed ^ (oprf.OPRF_DOMAIN << 96))  # noqa: E731
    n1 = p.big_lwe_dimension + 1
    prf = {}
    for bits, want in ((32, stream().uniform_u32(n1).astype(np.uint64)),
                       (64, stream().uniform_u64(n1))):
        got = oprf.pseudo_random_lwe(p, seed, bits)
        differing = int((got != want).sum()) + int(got.shape != (n1,))
        wrong += differing
        prf[f"bits_{bits}"] = {"words_differing": differing, "max_word": int(got.max())}
    if prf["bits_32"]["max_word"] >= 1 << 32:
        wrong += 1
    return {"wrong": wrong, "line": {
        "params": "V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
        "whole_bsk_seconds": whole_s, "ggsws": p.lwe_dimension, "chunks": chunks,
        "pseudo_random_lwe": prf, "wrong": wrong}}


def decrypt_rows(ck, rows, torus) -> list:
    """The messages of (B, n+1) int64 word rows under a shortint client key."""
    from tfhe_tpu_torch.shortint import Ciphertext

    p = ck.params
    return [ck.decrypt_raw(Ciphertext(row, degree=p.total_modulus - 1, noise_level=1,
                                      message_modulus=p.message_modulus,
                                      carry_modulus=p.carry_modulus))
            for row in torus.to_u64(rows)]


def placed_key_bytes(mesh, keys) -> dict:
    """Bytes of the given keys (tensors, KeyswitchKeyLimbs, RoundedKeyNtt)
    that each distinct device of the mesh holds: the key itself where it
    lies there, else its copy there."""
    from tfhe_tpu_torch.parallel import mesh as pmesh

    out = {}
    for dev in mesh.distinct_devices():
        total = 0
        for key in keys:
            placed = pmesh.place(key, dev)
            for t in ((placed.words, placed.limbs) if hasattr(placed, "limbs")
                      else (placed.data,) if hasattr(placed, "round_bits") else (placed,)):
                total += t.numel() * t.element_size()
        out[str(dev)] = total
    return out


def multi_device_phase(kernels, torus, ck, sk, served, ick, isk, seed: int) -> dict:
    """Phase 37 at the 2_2 widths on phase 3's key: the batch mesh
    (sharded_ks_pbs on the exact key, sharded_ks_pbs_mxu on the rounded
    key) at B = 512 on a mesh of every visible card and on MESH_SLOTS slots
    of cuda:0, against the unsharded ks_pbs_batch and decrypted, with the
    keys' uploads counted (a host-resident copy of the keys: one upload a
    distinct device, none on the second call); the poly-sharded PBS at B =
    1 and 4 over D = 1, 2 and 4 slots against K2's exact rotation, with K9's
    launches; the latency route's FheUint8 add over LATENCY_SLOTS slots."""
    import dataclasses

    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import server
    from tfhe_tpu_torch.parallel import mesh as pmesh
    from tfhe_tpu_torch.parallel import poly_shard as pps
    from tfhe_tpu_torch.shortint.params import MsNoiseReduction
    from tfhe_tpu_torch.shortint.server_key import upload_batch

    p = sk.params
    dev = torch.device("cuda", 0)
    cts, vals = served["cts"][0], served["inputs"][0]
    ct = upload_batch([c.data for c in cts], dev)
    lut = torus.from_u64(served["lut"].acc, dev).expand(BATCH, -1, -1).contiguous()
    want_msgs = [(3 * int(v) + 1) % 16 for v in vals]
    args = (p.ks_base_log, p.ks_level, p.pbs_base_log, p.pbs_level)
    centered = p.ms_noise_reduction == MsNoiseReduction.CENTERED_MEAN
    exact = sk.exact_bsk_ntt()
    unsharded = {
        "exact": server.ks_pbs_batch(ct, lut, sk.ks_key, exact, sk.dp, *args,
                                     centered_ms=centered),
        "mxu": server.ks_pbs_batch(ct, lut, sk.ks_key, sk.bsk_ntt, sk.bsk_ntt.dp, *args,
                                   centered_ms=centered, trunc_acc=True)}
    dps = {"exact": sk.dp, "mxu": sk.bsk_ntt.dp}
    meshes = {"cards": pmesh.make_mesh(),
              f"cuda0_x{MESH_SLOTS}": pmesh.make_mesh([dev] * MESH_SLOTS)}
    # a mesh of unindexed "cuda" slots is the current card: a key already
    # there is used as it is, not copied
    named = pmesh.make_mesh(["cuda"] * 2)
    before = pmesh.replicate.uploads
    same = pmesh.replicate(named, sk.ks_key)
    unindexed = {"distinct_devices": [str(d) for d in named.distinct_devices()],
                 "key_uploads": pmesh.replicate.uploads - before}
    wrong = int(unindexed["key_uploads"] != 0 or named.distinct_devices() != [dev]
                or any(x is not sk.ks_key for x in same))
    batch_line = {}
    for m_tag, mesh in meshes.items():
        for mode, entry in (("exact", pmesh.sharded_ks_pbs), ("mxu", pmesh.sharded_ks_pbs_mxu)):
            # the keys as a host holds them: fresh copies off the card, placed
            # once a distinct device at the first call
            host_ks = dataclasses.replace(sk.ks_key, words=sk.ks_key.words.cpu(),
                                          limbs=sk.ks_key.limbs.cpu())
            key = (exact.cpu() if mode == "exact"
                   else dataclasses.replace(sk.bsk_ntt, data=sk.bsk_ntt.data.cpu()))
            runs = []
            for _ in range(2):
                before = pmesh.replicate.uploads
                out, launches, secs, host_secs = counted(kernels, lambda: entry(
                    mesh, ct, lut, host_ks, key, dps[mode], *args, centered_ms=centered))
                runs.append({"seconds": secs, "host_seconds": host_secs,
                             "pbs_per_s": BATCH / secs, "launches": launches,
                             "key_uploads": pmesh.replicate.uploads - before})
            differing = int((out != unsharded[mode]).sum())
            wrong_dec = sum(g != w for g, w in zip(decrypt_rows(ck, out, torus), want_msgs))
            wrong += differing + wrong_dec + runs[1]["key_uploads"]
            wrong += runs[0]["key_uploads"] != 2 * len(mesh.distinct_devices())
            batch_line[f"{m_tag}_{mode}"] = {
                "slots": mesh.size, "distinct_devices": len(mesh.distinct_devices()),
                "first_call": runs[0], "second_call": runs[1],
                "words_differing_from_unsharded": differing, "wrong": wrong_dec,
                "key_bytes_by_device": placed_key_bytes(mesh, (host_ks, key))}
    # the poly-sharded PBS: K1, then K9's fused entry (every slot cuda:0),
    # against K1 and K2's exact rotation, each timed on its second call
    poly_line, poly_runs, prep_runs, k2_exact = {}, {}, {}, {}
    steps_runs, steps_line = {}, {}
    for b in POLY_BATCHES:
        args_b = (ct[:b], lut[:b])
        runs = [counted(kernels, lambda: server.ks_pbs_batch(
            *args_b, sk.ks_key, exact, sk.dp, *args, centered_ms=centered)) for _ in range(2)]
        k2_exact[b] = {"seconds": runs[1][2], "first_seconds": runs[0][2],
                       "host_share": runs[1][3] / runs[1][2], "launches": runs[1][1],
                       "out": runs[1][0]}
    for d in POLY_SLOTS:
        mesh = pmesh.make_mesh([dev] * d, "poly")
        evals, prep_launches, prep_s, _ = counted(kernels, lambda: pps.prepare_bsk_poly_sharded(
            mesh, torus.from_u64(sk._bsk_coeff.data, dev)))
        one_tensor = evals.whole is not None and all(
            part.data_ptr() == evals.whole[s].data_ptr() for s, part in enumerate(evals.parts))
        wrong += (prep_launches["poly_shard_forward"] != d or prep_launches["poly_shard_cross"] != d
                  or not one_tensor)
        prep_runs[d] = prep_launches
        t = pps.device_tables(p.polynomial_size, d, str(dev))
        for b in POLY_BATCHES:
            args_b = (ct[:b], lut[:b])
            runs = [counted(kernels, lambda: pps.sharded_ks_pbs_poly(
                mesh, *args_b, sk.ks_key, evals, *args, centered_ms=centered)) for _ in range(2)]
            out, launches, _, _ = runs[0]
            _, _, secs, host_secs = runs[1]
            want = k2_exact[b]["out"]
            differing = int((out != want).sum())
            wrong_dec = sum(g != w for g, w in zip(decrypt_rows(ck, out, torus), want_msgs[:b]))
            steps = sum(launches[f"poly_shard_{e}"] for e in ("forward", "cross", "inverse"))
            fused = launches["poly_shard_rotate"]
            # one card: one fused launch a call and no step-entry launch
            wrong += differing + wrong_dec + (fused != 1) + (steps != 0)
            wrong += launches["keyswitch"] != 1 or launches["blind_rotate"] != 0
            # the fused kernel alone on this call's switched inputs
            msed = server.ks_ms_batch(ct[:b], sk.ks_key, p.polynomial_size.bit_length(),
                                      p.ks_base_log, p.ks_level, centered)
            rotate_ms = cuda_ms(lambda: kernels.poly_shard_rotate(
                msed[:, :-1], msed[:, -1], lut[:b], evals.whole, t, p.pbs_base_log,
                p.pbs_level), 3)
            poly_runs[(d, b)] = launches
            poly_line[f"d{d}_b{b}"] = {
                "slots": d, "batch": b, "seconds_a_pbs": secs / b, "seconds": secs,
                "first_call_seconds": runs[0][2], "host_share": host_secs / secs,
                "fused_launches": fused, "step_entry_launches": steps,
                "k9_launches_a_pbs": (fused + steps) / b, "launches": launches,
                "rotate_ms": rotate_ms, "rotate_us_a_step": rotate_ms * 1e3 / p.lwe_dimension,
                "plan": kernels.poly_rotate_plan(0, d, p.glwe_dimension + 1, p.pbs_level,
                                                 p.polynomial_size),
                "k2_exact_seconds": k2_exact[b]["seconds"],
                "k2_exact_host_share": k2_exact[b]["host_share"],
                "prepare_key_seconds": prep_s, "prepare_key_launches": {
                    e: prep_launches[f"poly_shard_{e}"] for e in ("forward", "cross", "inverse")},
                "sharded_key_bytes": evals.nbytes, "key_one_tensor": one_tensor,
                "words_differing_from_k2_exact": differing, "wrong": wrong_dec}
        if d == K9_STEPS_ROUTE[0]:
            # the route of slots on distinct cards ("steps": the step loop on
            # K9's three step entries, each once a CMux step a slot), forced
            # on this one-card mesh at one batch
            b = K9_STEPS_ROUTE[1]
            chosen = kernels.poly_rotation_route
            kernels.poly_rotation_route = lambda *a: "steps"
            try:
                out, launches, secs, host_secs = counted(kernels, lambda: pps.sharded_ks_pbs_poly(
                    mesh, ct[:b], lut[:b], sk.ks_key, evals, *args, centered_ms=centered))
            finally:
                kernels.poly_rotation_route = chosen
            differing = int((out != k2_exact[b]["out"]).sum())
            wrong_dec = sum(g != w for g, w in zip(decrypt_rows(ck, out, torus), want_msgs[:b]))
            by_entry = {e: launches[f"poly_shard_{e}"] for e in ("forward", "cross", "inverse")}
            wrong += differing + wrong_dec + (launches["poly_shard_rotate"] != 0)
            wrong += any(v != d * p.lwe_dimension for v in by_entry.values())
            wrong += launches["keyswitch"] != 1 or launches["blind_rotate"] != 0
            steps_runs = by_entry
            steps_line = {
                "slots": d, "batch": b, "seconds_a_pbs": secs / b, "host_share": host_secs / secs,
                "step_entry_launches": by_entry, "fused_launches": launches["poly_shard_rotate"],
                "words_differing_from_k2_exact": differing, "wrong": wrong_dec}
    wrong += not steps_line
    # K9's three step entries on the sharded product (one card: the step
    # entries' path besides the key's preparation)
    pm_mesh = pmesh.make_mesh([dev] * MESH_SLOTS, "poly")
    rng_pm = np.random.default_rng(seed + 1)
    pa, pb = (rng_pm.integers(0, 1 << 64, (2, p.polynomial_size), dtype=np.uint64)
              for _ in range(2))
    prod, pm_launches, pm_s, _ = counted(kernels, lambda: pps.sharded_negacyclic_polymul(
        pm_mesh, torus.from_u64(pa, dev), torus.from_u64(pb, dev)))
    from tfhe_tpu_torch.ops import ntt as pntt

    pm_differing = int((torus.to_u64(prod) != pntt.negacyclic_polymul_u64(
        pa, pb, pntt.make_plan(p.polynomial_size, 4))).sum())
    wrong += pm_differing + (pm_launches["poly_shard_forward"] != 2 * MESH_SLOTS
                             or pm_launches["poly_shard_cross"] != 2 * MESH_SLOTS
                             or pm_launches["poly_shard_inverse"] != MESH_SLOTS)
    polymul_line = {"slots": MESH_SLOTS, "rows": 2, "seconds": pm_s, "launches": pm_launches,
                    "words_differing_from_plain_ntt": pm_differing}
    # the latency route: a FheUint8 add with every round one PBS split over
    # LATENCY_SLOTS slots
    rounds = {"n": 0}
    route = pps.sharded_ks_pbs_poly

    def counted_route(*a, **k):
        rounds["n"] += 1
        return route(*a, **k)

    rng = np.random.default_rng(seed)
    x, y = (int(v) for v in rng.integers(0, 256, 2))
    a, b = ick.encrypt_radix(x, 4), ick.encrypt_radix(y, 4)
    pps.set_latency_mesh(pmesh.make_mesh([dev] * LATENCY_SLOTS, "poly"))
    pps.sharded_ks_pbs_poly = counted_route
    try:
        isk.key._ensure_poly_shard(pps.latency_mesh()[0])
        out, lat_launches, lat_s, lat_host_s = counted(kernels, lambda: isk.add_parallelized(a, b))
        got = ick.decrypt_radix(out)
    finally:
        pps.sharded_ks_pbs_poly = route
        pps.set_latency_mesh(None)
    wrong += got != (x + y) % 256 or rounds["n"] == 0
    wrong += lat_launches["poly_shard_rotate"] != rounds["n"] or sum(
        lat_launches[f"poly_shard_{e}"] for e in ("forward", "cross", "inverse"))
    latency_line = {"slots": LATENCY_SLOTS, "x": x, "y": y, "decrypted": got,
                    "rounds": rounds["n"], "seconds": lat_s, "host_seconds": lat_host_s,
                    "launches": lat_launches, "wrong": int(got != (x + y) % 256)}
    return {"wrong": wrong, "poly_runs": poly_runs, "prep_runs": prep_runs,
            "polymul_launches": pm_launches, "steps_route_launches": steps_runs, "line": {
        "params": "V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128", "batch": BATCH,
        "visible_cards": torch.cuda.device_count(), "batch_mesh": batch_line,
        "unindexed_cuda_mesh": unindexed,
        "serve_pbs_per_s": served["line"]["pbs_per_s"],
        "poly": poly_line, "poly_steps_route": steps_line,
        "k2_exact": {f"b{b}": {k: v for k, v in fig.items() if k != "out"}
                     for b, fig in k2_exact.items()},
        "sharded_polymul": polymul_line, "latency_fheuint8_add": latency_line, "wrong": wrong,
        "note": "one card: the slots of a mesh on cuda:0 run in turn; no scaling across "
                "cards is measured"}}


def c_api_phase(kernels) -> dict:
    """Phase 38: the C API over the port built on the card's host (gcc,
    c_api_torch/build.py; Python.h from sysconfig's include directory,
    libpython linked) and its test program run at config kind 1
    (DEFAULT_PARAMS, the 2_2 set: K1 and K2 v7) on cuda: its seconds a call."""
    import importlib.util
    import os
    import sysconfig

    from tfhe_tpu_torch.utils.build import CSRC

    repo = CSRC.parents[1]
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(f"no Python.h under {include}")
    spec = importlib.util.spec_from_file_location("c_api_torch_build",
                                                  repo / "c_api_torch" / "build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    t0 = time.perf_counter()
    lib, program = build.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = build.run(program, 1, "cuda")
    run_s = time.perf_counter() - t0
    seconds = {}
    for line in result.stdout.splitlines():
        if line.startswith("seconds "):
            _, name, value = line.split()
            seconds[name] = float(value)
    ok = "c_api: ALL OK" in result.stdout
    return {"wrong": int(not ok), "line": {
        "config_kind": 1, "params": "DEFAULT_PARAMS", "device": "cuda",
        "python_include": include, "build_seconds": build_s, "run_seconds": run_s,
        "seconds_a_call": seconds, "all_ok": ok,
        "stdout_tail": result.stdout.splitlines()[-3:]}}


# 32-bit multiplies a Montgomery product x y R^-1 mod p (ntt_common.cuh
# mont_mul): the low and high words of t = x y, the low word of m = t p'
# and the high word of m p; the low word of m p needs none (it is -t mod
# 2^32, and the carry out of t + m p is t != 0)
MONT_MUL_MULTIPLIES = 4


def k9_step_modmuls(d: int, b: int, k1: int, n_poly: int, levels: int) -> int:
    """Montgomery products of one CMux step of the four-step split on all d
    slots, the least a step needs: the twists, twiddles and size-C
    butterflies of the forward and inverse stages ((C / 2) log2 C products
    a transform), the size-D transforms as fast ones ((D / 2) log2 D a D
    points, none at D = 1), the key product, Garner."""
    np_, c = EXACT_PRIMES, n_poly // d
    log_c, log_d = c.bit_length() - 1, d.bit_length() - 1
    rows = b * k1
    modmuls = d * np_ * (rows * levels * (2 * c + (c // 2) * log_c)        # entry a
                         + rows * (2 * c + (c // 2) * log_c))             # entry c
    modmuls += np_ * n_poly * (levels * rows * log_d // 2                   # entry b: size D
                               + levels * k1 * rows                         # key product
                               + rows * log_d // 2)                         # size-D inverse
    modmuls += d * rows * c * np_ * (np_ - 1) // 2                          # Garner
    return modmuls


def k9_bound(d: int, b: int, k1: int, n_poly: int, levels: int) -> dict:
    """Least time for one CMux step's three K9 step entries on all d slots:
    each input read once and each output written once (u64 words at 8
    bytes; residues and the key slices' residues, below 2^30, at 4),
    against their Montgomery products (k9_step_modmuls) on the CUDA cores'
    32-bit integer rate, MONT_MUL_MULTIPLIES multiplies a product."""
    np_ = EXACT_PRIMES
    rows = b * k1
    words = (rows * n_poly                                  # entry a in
             + rows * n_poly)                               # entry c out
    residues = (2 * levels * rows * np_ * n_poly            # entry a out, entry b in
                + levels * k1 * k1 * np_ * n_poly           # the key slices
                + 2 * rows * np_ * n_poly)                  # entry b out, entry c in
    t_bytes = (8 * words + 4 * residues) / HBM_BYTES_PER_S
    t_ops = MONT_MUL_MULTIPLIES * k9_step_modmuls(d, b, k1, n_poly, levels) / INT32_MUL_PER_S
    return {"ms": max(t_bytes, t_ops) * 1e3, "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "ops_ms": t_ops * 1e3}


def k9_rotate_bound(d: int, b: int, k1: int, n_poly: int, levels: int, n_steps: int) -> dict:
    """Least time for K9's fused entry, a whole rotation: its inputs read
    once (the key's slices at 4 bytes a residue, the LUT's words, the int32
    mask and body, the u32 tables) and its words written once, against
    n_steps steps' Montgomery products (k9_step_modmuls) at
    MONT_MUL_MULTIPLIES 32-bit multiplies each; beside it n_steps times k9_bound's step (the step
    entries' bound, whose exchanges pass through device memory)."""
    np_ = EXACT_PRIMES
    nbytes = (4 * n_steps * levels * k1 * k1 * np_ * n_poly        # key slices
              + 8 * b * k1 * n_poly * 2                            # LUT in, words out
              + 4 * b * (n_steps + 1)                              # mask, body
              + 4 * np_ * 6 * n_poly + 4 * np_ * 2 * d)            # tables
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (MONT_MUL_MULTIPLIES * n_steps * k9_step_modmuls(d, b, k1, n_poly, levels)
             / INT32_MUL_PER_S)
    return {"ms": max(t_bytes, t_ops) * 1e3, "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "ops_ms": t_ops * 1e3,
            "steps_bound_ms": n_steps * k9_bound(d, b, k1, n_poly, levels)["ms"]}


def k9_vs_plain(kernels, torus, sk, seed: int, errs: dict) -> dict:
    """K9's three entries against their plain versions (ops/four_step.py) on
    the card at every shape the poly path runs (K9_SHAPES: N = 2048, k+1 =
    2, l = 1, the key slices of phase 3's key).  Each entry is timed from
    CUDA graphs (the device's time: "ms"), in event windows of K9_REPS
    launches through its wrapper (the host's enqueue time is in those) and
    beside its plain version; one step of the three entries on every slot
    beside k9_bound."""
    import torch

    from tfhe_tpu_torch.ops import four_step
    from tfhe_tpu_torch.parallel import mesh as pmesh
    from tfhe_tpu_torch.parallel import poly_shard as pps

    p = sk.params
    dev = torch.device("cuda", 0)
    n_poly, k1, levels = p.polynomial_size, p.glwe_dimension + 1, p.pbs_level
    gen = torch.Generator(device=dev).manual_seed(seed)
    figs = {}
    for d, b in K9_SHAPES:
        t = four_step.device_tables(n_poly, d, str(dev))
        c, rows = n_poly // d, b * k1
        mesh = pmesh.make_mesh([dev] * d, "poly")
        evals = pps.prepare_bsk_poly_sharded(mesh, torus.from_u64(sk._bsk_coeff.data[:2], dev))
        x = torch.randint(-(1 << 62), 1 << 62, (rows, c), generator=gen, device=dev)
        ya = torch.remainder(torch.randint(0, 1 << 62, (d, levels, rows, EXACT_PRIMES, c // d),
                                           generator=gen, device=dev),
                             t.dp.ps.view(1, 1, 1, -1, 1)).to(torch.int32)
        yb = torch.remainder(torch.randint(0, 1 << 62, (d, rows, EXACT_PRIMES, c // d),
                                           generator=gen, device=dev),
                             t.dp.ps.view(1, 1, -1, 1)).to(torch.int32)
        key = evals.parts[d - 1][1]
        entries = {
            "forward": (lambda: kernels.poly_shard_forward(x, t, d - 1, levels, p.pbs_base_log),
                        lambda: four_step.forward_plain(x, t, d - 1, levels, p.pbs_base_log)),
            "forward_words": (lambda: kernels.poly_shard_forward(x, t, d - 1),
                              lambda: four_step.forward_plain(x, t, d - 1)),
            "cross": (lambda: kernels.poly_shard_cross(ya, t, key, batch=b, k1=k1),
                      lambda: four_step.cross_plain(ya, t, key, batch=b, k1=k1)),
            "cross_forward_only": (lambda: kernels.poly_shard_cross(ya, t),
                                   lambda: four_step.cross_plain(ya, t)),
            "inverse": (lambda: kernels.poly_shard_inverse(yb, t, d - 1),
                        lambda: four_step.inverse_plain(yb, t, d - 1))}
        tag = f"d{d}_b{b}"
        fig = {"slots": d, "batch": b, "C": c}
        for name, (kernel, plain) in entries.items():
            errs[f"k9_{name}_{tag}"] = fig[f"{name}_words_differing"] = max_abs_err(
                kernel(), plain())
            fig[f"{name}_ms"] = graph_ms(kernel)
            fig[f"{name}_events_ms"], fig[f"{name}_host_ms"] = launch_ms(kernel, K9_REPS)
            fig[f"{name}_plain_ms"] = cuda_ms(plain, 3)
        # one step: entries a, b and c on every slot (the exchanges not counted)
        for suffix in ("ms", "events_ms", "host_ms", "plain_ms"):
            fig[f"step_{suffix}"] = d * sum(fig[f"{e}_{suffix}"]
                                            for e in ("forward", "cross", "inverse"))
        fig["bound"] = k9_bound(d, b, k1, n_poly, levels)
        figs[tag] = fig
    return figs


# K9's fused entry against its plain version: (D, B) at the 2_2 widths on a
# random key of K9_ROTATE_STEPS steps (tier 0), and the wide shape (k+1 =
# 7, l = 3, base 2^8) at D = 1, 2, 4 over 4 steps (tiers 3, 2, 1)
POLY_ROTATE_SLOTS = (1, 2, 4, 8)
K9_ROTATE_STEPS = 64
K9_WIDE = (7, 3, 8, 4)        # k+1, l, base_log, steps
# the plans the kernel must choose at those shapes (D, k+1, l, N): at the
# 2_2 widths every state in shared memory, one cluster of at most 16 blocks
# a ciphertext (two primes a block at D = 8); at K9_WIDE the key, then the
# tables, then the words and rows leave shared memory as D falls
K9_PLAN_KEYS = ("primes_per_block", "cluster", "tier", "shared_memory_bytes")
K9_PLANS = {(1, 2, 1, 2048): (1, 4, 0, 180224), (2, 2, 1, 2048): (1, 8, 0, 90112),
            (4, 2, 1, 2048): (1, 16, 0, 45056), (8, 2, 1, 2048): (2, 16, 0, 40960),
            (4, 7, 3, 2048): (1, 16, 1, 126976), (2, 7, 3, 2048): (1, 8, 2, 229376),
            (1, 7, 3, 2048): (1, 4, 3, 0)}


def k9_rotate_vs_plain(kernels, sk, seed: int, errs: dict) -> dict:
    """K9's fused entry (kernels.poly_shard_rotate) against its plain
    version (ops/four_step.py rotate_steps on the plain stages) on the card:
    at N = 2048, k+1 = 2, l = 1 (phase 3's base) on random keys cut to
    K9_ROTATE_STEPS steps at D in POLY_ROTATE_SLOTS and B = 1, 4; at K9_WIDE
    over its steps at D = 1, 2, 4, B = 1, where the plan puts the state in
    global memory step by step.  Each is timed (CUDA events) beside its
    plain version."""
    import torch

    from tfhe_tpu_torch.ops import four_step

    p = sk.params
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_poly = p.polynomial_size
    shapes = ([(d, b, p.glwe_dimension + 1, p.pbs_level, p.pbs_base_log, K9_ROTATE_STEPS)
               for d in POLY_ROTATE_SLOTS for b in POLY_BATCHES]
              + [(d, 1) + K9_WIDE for d in (1, 2, 4)])
    figs = {}
    for d, b, k1, levels, base_log, steps in shapes:
        t = four_step.device_tables(n_poly, d, str(dev))
        key = torch.remainder(
            torch.randint(0, 1 << 62, (d, steps, levels, k1, k1, EXACT_PRIMES, t.c),
                          generator=gen, device=dev), t.dp.ps.view(-1, 1)).to(torch.int32)
        lut = torch.randint(-(1 << 62), 1 << 62, (b, k1, n_poly), generator=gen, device=dev)
        mask = torch.randint(0, 2 * n_poly, (b, steps), generator=gen, device=dev)
        body = torch.randint(0, 2 * n_poly, (b,), generator=gen, device=dev)

        def kernel():
            return kernels.poly_shard_rotate(mask, body, lut, key, t, base_log, levels)

        def plain():
            return four_step.rotate_steps(mask, body, lut, list(key.unbind(0)), [t] * d,
                                          base_log, levels)

        tag = f"d{d}_b{b}_k1_{k1}_l{levels}"
        plan = kernels.poly_rotate_plan(0, d, k1, levels, n_poly)
        want_plan = K9_PLANS.get((d, k1, levels, n_poly))
        if want_plan is not None and tuple(plan[k] for k in K9_PLAN_KEYS) != want_plan:
            raise RuntimeError(f"K9's fused plan at {tag}: {plan}, expected "
                               f"{dict(zip(K9_PLAN_KEYS, want_plan))}")
        errs[f"k9_rotate_{tag}"] = err = max_abs_err(kernel(), plain())
        figs[tag] = {"slots": d, "batch": b, "k1": k1, "levels": levels, "steps": steps,
                     "plan": plan, "words_differing": err, "ms": cuda_ms(kernel, 5),
                     "plain_ms": cuda_ms(plain, 1), "active_clusters": plan["active_clusters"]}
    return figs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs only on a CUDA card")

    from tfhe_tpu_torch.ops import bsk_prep, kernels, ntt, server, server128, torus
    from tfhe_tpu_torch.shortint import (
        V1_4_PARAM_GPU_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 as GROUP_3,
        V1_4_PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 as MB_PARAMS,
        TPU_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 as TPU_GROUP_2,
        V1_4_COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 as COMP_PARAMS,
        V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 as PARAMS,
        V1_4_NOISE_SQUASHING_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 as SQ_PARAMS,
        TEST_NOISE_SQUASHING_PARAM as SQ_TEST, TEST_PARAM_MESSAGE_2_CARRY_2 as TEST_PARAMS,
        ClientKey, CompressionKey, NoiseSquashingKey, NoiseSquashingPrivateKey, ServerKey)
    from tfhe_tpu_torch.shortint import params as shortint_params
    from tfhe_tpu_torch.shortint.compression import TEST_COMP_PARAM, extract_switched
    from tfhe_tpu_torch.shortint.server_key import upload_batch

    started = time.perf_counter()
    dev = torch.device("cuda")
    card = gpu_line()

    # 1. the card and the toolchain
    emit({"phase": "device", "gpu": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_version(kernels),
          "python": sys.version.split()[0]})

    # 2. build the kernels (one nvcc per source, started together)
    t0 = time.perf_counter()
    kernels.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": kernels.source_paths()})
    # the registers' compile runs beside phases 3-13 (stopped at exit if a
    # phase fails first)
    ptxas = ptxas_start(kernels)
    atexit.register(ptxas_stop, ptxas)
    # the test vectors' CPU emission runs beside the card's phases (phase 30
    # compares it with the card's)
    vectors_cpu = test_vectors_start()

    # 3. keygen and key upload
    p = PARAMS
    t0 = time.perf_counter()
    ck = ClientKey(p, seed=args.seed)
    sk = ServerKey(ck, seed=args.seed + 1, device="cuda")
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    if not sk.trunc_acc or sk.bsk_ntt.num_primes != V7_PRIMES:
        raise RuntimeError("the production 2_2 key did not select v7 mode on three primes")
    emit({"phase": "keygen", "params": "V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
          "n": p.lwe_dimension, "N": p.polynomial_size, "k": p.glwe_dimension,
          "pbs_level": p.pbs_level, "pbs_base_log": p.pbs_base_log,
          "ks_level": p.ks_level, "ks_base_log": p.ks_base_log,
          "bsk_floored": sk._bsk_floored, "v7_mode": sk.trunc_acc,
          "seconds": keygen_s,
          "bsk_primes": sk.bsk_ntt.num_primes,
          "device_key_bytes": (sk.ksk.numel() * 8 + sk.ks_key.limbs.numel()
                               + key_bytes(sk.bsk_ntt))})

    # 4. serve on the classic key
    served = serve_rounds(ck, sk, args.seed, kernels)
    emit({"phase": "serve", **served["line"]})
    if served["line"]["wrong"]:
        raise RuntimeError(f"{served['line']['wrong']} outputs decrypted wrong")
    launches = served["launches"]
    if not (launches["keyswitch"] and launches["blind_rotate"]
            and launches["keyswitch_imma"] == launches["keyswitch"]):
        raise RuntimeError(f"the classic path skipped a kernel or ran K1's generic "
                           f"kernel: {launches}")

    # 5. compression keygen from the classic client key
    cp = COMP_PARAMS
    t0 = time.perf_counter()
    ckey = CompressionKey(ck, seed=args.seed + 20, device="cuda")
    torch.cuda.synchronize()
    dk = ckey.decompression
    emit({"phase": "keygen_compression",
          "params": "V1_4_COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
          "seconds": time.perf_counter() - t0, "br_floored": dk._bsk_floored,
          "v7_mode": dk.trunc_acc, "pksk_device_bytes": ckey.pksk.numel() * 8,
          "pksk_limbs_device_bytes": (ckey.pks_key.limbs.numel()
                                      if hasattr(ckey.pks_key, "limbs") else 0),
          "decompression_key_primes": dk.bsk_ntt.num_primes,
          "decompression_key_device_bytes": key_bytes(dk.bsk_ntt)})
    if dk._bsk_floored != 15 or not dk.trunc_acc or dk.bsk_ntt.num_primes != V7_PRIMES:
        raise RuntimeError("the decompression key was not floored at 15 or not in v7 mode "
                           "on three primes")
    if not isinstance(ckey.pks_key, kernels.PackingKeyswitchKeyLimbs):
        raise RuntimeError("the compression key holds no byte layout of its packing key "
                           "for K4's tensor-core kernel")

    # 6. compress the chained round's device-resident outputs (K4's
    # tensor-core kernel)
    chained, chained_want = served["chained"], served["chained_want"]
    # (cold: the process's first K4 launch; then a warm call on the same list)
    packed, comp_launches, compress_s, compress_host_s = counted(
        kernels, lambda: ckey.compress(chained))
    warm, warm_launches, warm_s, warm_host_s = counted(kernels, lambda: ckey.compress(chained))
    raw_bytes = BATCH * (p.polynomial_size * p.glwe_dimension + 1) * 8
    emit({"phase": "compress", "batch": BATCH, "glwes": packed.glwes.shape[0],
          "seconds": compress_s, "host_seconds": compress_host_s, "warm_seconds": warm_s,
          "warm_host_seconds": warm_host_s, "compressed_bytes": packed.glwes.nbytes,
          "uncompressed_bytes": raw_bytes, "ratio": raw_bytes / packed.glwes.nbytes,
          "launches": comp_launches})
    for got in (comp_launches, warm_launches):
        if got != only(kernels, packing_keyswitch=1, packing_keyswitch_imma=1):
            raise RuntimeError(f"compress did not run K4's tensor-core kernel alone, once: "
                               f"{got}")
    if not (warm.glwes == packed.glwes).all():
        raise RuntimeError("a second compress of the same list gave other words")

    # 7. decompress all 512 (one K2 launch, v7 mode, n = 1024), then a subset
    # across the GLWE boundary
    dec_outs, decomp_launches, decompress_s, _ = counted(kernels, lambda: ckey.decompress(packed))
    wrong = sum(ck.decrypt(ct) != want for ct, want in zip(dec_outs, chained_want))
    subset = [cp.lwe_per_glwe - 1, cp.lwe_per_glwe, BATCH - 1]
    sub_outs, sub_launches, subset_s, _ = counted(
        kernels, lambda: ckey.decompress(packed, indices=subset))
    wrong += sum(ck.decrypt(sub_outs[i]) != chained_want[j] for i, j in enumerate(subset))
    emit({"phase": "decompress", "batch": BATCH, "steps": cp.packing_ks_polynomial_size
          * cp.packing_ks_glwe_dimension, "seconds": decompress_s, "launches": decomp_launches,
          "subset": subset, "subset_seconds": subset_s, "subset_launches": sub_launches,
          "outputs_checked": BATCH + len(subset), "wrong": wrong})
    if wrong:
        raise RuntimeError(f"{wrong} decompressed outputs decrypted wrong")
    for got in (decomp_launches, sub_launches):
        if got != only(kernels, blind_rotate=1):
            raise RuntimeError(f"decompress did not run K2 alone, once: {got}")

    # 8. multi-bit keygen and key upload
    mp = MB_PARAMS
    t0 = time.perf_counter()
    mck = ClientKey(mp, seed=args.seed + 10)
    msk = ServerKey(mck, seed=args.seed + 11, device="cuda")
    torch.cuda.synchronize()
    mb_keygen_s = time.perf_counter() - t0
    emit({"phase": "keygen_multibit",
          "params": "V1_4_PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
          "n": mp.lwe_dimension, "N": mp.polynomial_size, "k": mp.glwe_dimension,
          "grouping": mp.grouping_factor, "pbs_level": mp.pbs_level,
          "pbs_base_log": mp.pbs_base_log, "ks_level": mp.ks_level,
          "ks_base_log": mp.ks_base_log, "mb_floored": msk._bsk_floored,
          "v9_mode": msk.trunc_acc, "seconds": mb_keygen_s,
          "bsk_primes": msk.bsk_ntt.num_primes,
          "device_key_bytes": (msk.ksk.numel() * 8 + msk.ks_key.limbs.numel()
                               + key_bytes(msk.bsk_ntt))})
    if not msk.trunc_acc or msk.bsk_ntt.num_primes != V9_PRIMES:
        raise RuntimeError("the GROUP_4 multi-bit key did not select v9 mode on three primes")

    # 9. serve on the multi-bit key
    mb_served = serve_rounds(mck, msk, args.seed + 12, kernels)
    emit({"phase": "serve_multibit", **mb_served["line"]})
    if mb_served["line"]["wrong"]:
        raise RuntimeError(f"{mb_served['line']['wrong']} outputs decrypted wrong")
    mb_launches = mb_served["launches"]
    if (mb_launches["blind_rotate_multibit"] != ROUNDS + 2
            or mb_launches["blind_rotate"] or not mb_launches["keyswitch"]
            or mb_launches["keyswitch_imma"] != mb_launches["keyswitch"]):
        raise RuntimeError(f"the multi-bit path did not run K1 (tensor cores) and K3 "
                           f"alone: {mb_launches}")

    # 10. modulus-switched compression on the classic and the multi-bit key:
    # KS + MS now (K1 once a ciphertext), the rotation later in exact mode
    # (K2 on the classic key, K3 on the multi-bit key), LUT (3x+1) % 16
    ms_launches, ms_runs = {}, {}
    for tag, c_key, s_key, srv_out, rotation in (
            ("classic", ck, sk, served, "blind_rotate"),
            ("multibit", mck, msk, mb_served, "blind_rotate_multibit")):
        cts, vals = srv_out["cts"][0], srv_out["inputs"][0]
        stored, switch_launches, switch_s, _ = counted(
            kernels, lambda: [s_key.switch_modulus_and_compress(ct) for ct in cts])
        s_key.exact_bsk_ntt()      # the unrounded key, uploaded at first use
        lut = s_key.generate_lookup_table(lambda x: (3 * x + 1) % 16)
        outs, lut_launches, lut_s, _ = counted(
            kernels, lambda: s_key.decompress_and_apply_lookup_table_batch(stored, lut))
        wrong = sum(c_key.decrypt_raw(ct) != (3 * int(v) + 1) % 16 for ct, v in zip(outs, vals))
        ms_launches[tag] = {"switch": switch_launches, "decompress": lut_launches}
        ms_runs[tag] = {"stored": stored, "outs": outs}
        emit({"phase": "modswitch_compress", "key": tag, "batch": BATCH,
              "switch_seconds": switch_s, "decompress_seconds": lut_s,
              "stored_bytes": sum(c.packed.nbytes for c in stored),
              "uncompressed_bytes": BATCH * cts[0].data.nbytes,
              "launches": ms_launches[tag], "outputs_checked": BATCH, "wrong": wrong})
        if wrong:
            raise RuntimeError(f"{wrong} modulus-switched outputs decrypted wrong ({tag})")
        other = "blind_rotate_multibit" if rotation == "blind_rotate" else "blind_rotate"
        lazy = 1 if rotation == "blind_rotate" else 0
        if (switch_launches["keyswitch"] != BATCH or lut_launches[rotation] != 1
                or switch_launches["keyswitch_imma"] != BATCH
                or lut_launches["blind_rotate_exact_lazy"] != lazy
                or lut_launches[other] or lut_launches["keyswitch"]):
            raise RuntimeError(f"modulus-switched compression ({tag}) did not run K1 "
                               f"then {rotation} once: {ms_launches[tag]}")

    # 11. noise-squashing keygen over phase 3's classic client key
    sqp = SQ_PARAMS
    t0 = time.perf_counter()
    sq_priv = NoiseSquashingPrivateKey(sqp, seed=args.seed + 30)
    nsk = NoiseSquashingKey(ck, sq_priv, seed=args.seed + 31, device="cuda")
    torch.cuda.synchronize()
    k1_sq = sqp.glwe_dimension + 1
    emit({"phase": "keygen_squashing",
          "params": "V1_4_NOISE_SQUASHING_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
          "n": p.lwe_dimension, "N": sqp.polynomial_size, "k": sqp.glwe_dimension,
          "base_log": sqp.decomp_base_log, "levels": sqp.decomp_level_count,
          "primes": list(nsk.plan128.primes), "seconds": time.perf_counter() - t0,
          "ntt_key_device_bytes": nsk.bsk128_ntt.numel() * 4,
          "standard_key_bytes": p.lwe_dimension * sqp.decomp_level_count * k1_sq * k1_sq
                                * sqp.polynomial_size * 16})

    # 12. squash the chained round's 512 device-resident outputs (one K1 and
    # one K5 launch), every output decrypted under the squashing key; then a
    # second, warm call
    sq_runs = [counted(kernels, lambda: nsk.squash_ciphertext_noise_batch(chained, sk))
               for _ in range(2)]
    squashed, sq_launches = sq_runs[0][0], sq_runs[0][1]
    wrong = sum(sq_priv.decrypt_squashed_noise_ciphertext(sq) != want
                for sq, want in zip(squashed, chained_want))
    wrong += sum(sq.degree != ct.degree for sq, ct in zip(squashed, chained))
    emit({"phase": "squash", "batch": BATCH, "seconds": sq_runs[0][2],
          "host_seconds": sq_runs[0][3], "warm_seconds": sq_runs[1][2],
          "warm_host_seconds": sq_runs[1][3], "launches": sq_launches,
          "outputs_checked": BATCH, "wrong": wrong})
    if wrong:
        raise RuntimeError(f"{wrong} squashed outputs decrypted wrong")
    for _, got, _, _ in sq_runs:
        if got != only(kernels, keyswitch=1, keyswitch_imma=1, blind_rotate128=1):
            raise RuntimeError(f"squash did not run K1 (tensor cores) and K5 once each: {got}")

    # 13. the exact blind rotation one CMux step a launch (K2's single-step
    # entry, the function of tfhe_tpu's build_cmux_step kernel) at the 2_2
    # shape on a random key, B = 512
    st_gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    st_rng = np.random.default_rng(args.seed + 5)
    n_poly, glwe_size = p.polynomial_size, p.glwe_dimension + 1
    st_args = (
        torch.from_numpy(st_rng.integers(0, 2 * n_poly, (BATCH, STEPWISE_STEPS))).to(dev),
        torch.from_numpy(st_rng.integers(0, 2 * n_poly, (BATCH,))).to(dev),
        torus.from_u64(st_rng.integers(0, 1 << 64, (BATCH, glwe_size, n_poly),
                                       dtype=np.uint64), dev),
        random_ntt_key((STEPWISE_STEPS, p.pbs_level, glwe_size, glwe_size), sk.dp, st_gen),
        sk.dp, p.pbs_base_log, p.pbs_level)
    stepwise, st_launches, st_s, _ = counted(kernels, lambda: server.blind_rotate_stepwise(*st_args))
    emit({"phase": "stepwise", "batch": BATCH, "steps": STEPWISE_STEPS, "seconds": st_s,
          "launches": st_launches})
    if st_launches != only(kernels, cmux_step=STEPWISE_STEPS,
                           cmux_step_exact_lazy=STEPWISE_STEPS):
        raise RuntimeError(f"blind_rotate_stepwise did not run K2's step entry (its lazy "
                           f"exact kernel) once a step: {st_launches}")
    t0 = time.perf_counter()
    ptxas_kernels = ptxas_report(kernels, ptxas)
    emit({"phase": "ptxas", "nvcc_flags": "-Xptxas -v", "kernels": ptxas_kernels,
          "wait_seconds": time.perf_counter() - t0})

    # 14-17. the integer layer on the classic and the multi-bit key, radix
    # storage and squash, the boolean gates
    from tfhe_tpu_torch import boolean as tb
    from tfhe_tpu_torch import integer as ti

    ick, isk = integer_keys(ti, ck, sk)
    integer_run = integer_phase(kernels, ti, ick, isk, args.seed + 40)
    emit({"phase": "integer", **integer_run["line"]})
    x, y = integer_run["x"], integer_run["y"]
    mick, misk = integer_keys(ti, mck, msk)
    mb_integer_line = integer_multibit_phase(kernels, mick, misk, x, y)
    emit({"phase": "integer_multibit", **mb_integer_line})
    storage_line = integer_storage_phase(kernels, ick, isk, nsk, sq_priv,
                                         integer_run["add_out"],
                                         (x + y) % integer_run["modulus"])
    emit({"phase": "integer_storage", **storage_line})
    boolean_run = boolean_phase(kernels, tb, args.seed + 50)
    emit({"phase": "boolean", **boolean_run["line"]})
    for tag, failed in (("integer", integer_run["wrong"]),
                        ("multi-bit integer", mb_integer_line["wrong"]),
                        ("stored or squashed FheUint64", storage_line["wrong"]),
                        ("boolean", boolean_run["line"]["wrong"])):
        if failed:
            raise RuntimeError(f"{failed} {tag} outputs decrypted wrong")

    # K2's step entry timed before phases 18-22 (and again beside the
    # kernel table's time, after them)
    step_probe_before = step_entry_probe(kernels, server, st_args)

    # 18-22. the high-level API through its entry points (its own keygen):
    # FheUint64 ops, the OPRF, a compressed server key, a KVStore and an
    # array, encrypted strings
    import tfhe_tpu_torch as th
    from tfhe_tpu_torch import strings as tstrings
    from tfhe_tpu_torch.hlapi import kv_store

    hl_run = hlapi_phase(kernels, th, args.seed + 60, integer_run["line"]["fheuint64"])
    emit({"phase": "hlapi", **hl_run["line"]})
    hl_ck, hl_sk = hl_run["ck"], hl_run["sk"]
    oprf_run = oprf_phase(kernels, th, hl_ck, hl_sk, args.seed + 61)
    emit({"phase": "oprf", **oprf_run["line"]})
    ckey_run = compressed_key_phase(kernels, th, hl_ck, args.seed + 62)
    emit({"phase": "compressed_key", **ckey_run["line"]})
    kv_run = kv_store_phase(kernels, th, kv_store, hl_ck, hl_sk, args.seed + 63)
    emit({"phase": "kv_store", **kv_run["line"]})
    str_run = strings_phase(kernels, th, tstrings, hl_ck, hl_sk)
    emit({"phase": "strings", **str_run["line"]})
    for tag, run in (("hlapi", hl_run), ("OPRF", oprf_run), ("compressed-key", ckey_run),
                     ("KVStore or array", kv_run), ("string", str_run)):
        if run["wrong"]:
            raise RuntimeError(f"{run['wrong']} {tag} outputs wrong (decrypted or words)")

    # 23-24. config 5: compact public-key encryption with ZK proofs, casts,
    # re-randomization; Trivium and Kreyvium over the boolean gates
    from tfhe_tpu_torch.apps import trivium

    pke_run = compact_pke_phase(kernels, th, hl_ck, hl_sk, args.seed + 70)
    emit({"phase": "compact_pke", **pke_run["line"]})
    triv_run = trivium_phase(kernels, trivium, boolean_run["bck"], boolean_run["bsk"],
                             args.seed + 71)
    emit({"phase": "trivium", **triv_run["line"]})
    for tag, run in (("compact-list", pke_run), ("Trivium/Kreyvium", triv_run)):
        if run["wrong"]:
            raise RuntimeError(f"{run['wrong']} {tag} outputs wrong")

    # 25-26. the remaining atomic patterns (KS32 through K1-32, PBS->KS, the
    # three KS_PBS sets, many-LUT on both keys, drift), and a client ->
    # server -> client round trip through the wire format
    from tfhe_tpu_torch import shortint as shortint_mod

    atomic_run = atomic_patterns_phase(kernels, shortint_mod, ck, sk, mck, msk, args.seed + 80)
    emit({"phase": "atomic_patterns", **atomic_run["line"]})
    wire_run = wire_phase(kernels, th, args.seed + 81)
    emit({"phase": "wire", **wire_run["line"]})
    for tag, run in (("atomic-pattern", atomic_run), ("wire", wire_run)):
        if run["wrong"]:
            raise RuntimeError(f"{run['wrong']} {tag} outputs wrong")

    # 27-30. squashed-noise compression (K6) of phase 12's squashed outputs
    # and of phase 14's FheUint64; WoPBS, AES over WoPBS and the test
    # vectors at the sets tfhe_tpu has for them
    from tfhe_tpu_torch import integer as tint
    from tfhe_tpu_torch.apps import aes as taes
    from tfhe_tpu_torch.apps import test_vectors as tvectors
    from tfhe_tpu_torch.shortint import noise_squashing as tns
    from tfhe_tpu_torch.shortint import wopbs as twopbs

    sqc_run = squash_compress_phase(kernels, tns, sq_priv, nsk, sk, squashed, chained_want,
                                    integer_run["add_out"], (x + y) % integer_run["modulus"],
                                    args.seed + 90)
    emit({"phase": "squash_compress", **sqc_run["line"]})
    # the shapes of K2's exact launches of phases 28-29 (the TEST shapes)
    with RotationShapes(kernels) as test_shapes:
        wopbs_run = wopbs_phase(kernels, shortint_mod, twopbs, args.seed + 91)
        emit({"phase": "wopbs", **wopbs_run["line"]})
        aes_run = aes_phase(kernels, shortint_mod, tint, twopbs, taes, args.seed + 92)
        emit({"phase": "aes", **aes_run["line"]})
    tv_run = test_vectors_phase(kernels, tvectors, vectors_cpu)
    emit({"phase": "test_vectors", **tv_run["line"]})
    for tag, run in (("squashed-compression", sqc_run), ("WoPBS", wopbs_run), ("AES", aes_run),
                     ("test-vector", tv_run)):
        if run["wrong"]:
            raise RuntimeError(f"{run['wrong']} {tag} outputs wrong")

    # 31-32. 3_3 through the entry points (K2's cluster kernel at N = 8192)
    # and every set that had never had a real-key round on the card
    s33_run = serve_3_3_phase(kernels, shortint_mod, tint, args.seed + 100)
    emit({"phase": "serve_3_3", **s33_run["line"]})
    ps_run = param_sets_phase(kernels, shortint_mod, args.seed + 110)
    emit({"phase": "param_sets", **ps_run["line"]})
    for tag, run in (("3_3", s33_run), ("parameter-set", ps_run)):
        if run["wrong"]:
            raise RuntimeError(f"{run['wrong']} {tag} outputs wrong")

    # 33. the GLWE keyswitch (K7), the common mask and the experimental core
    # (K8) at the 2_2 widths
    rp_run = research_primitives_phase(kernels, torus, ck, sk, args.seed + 120)
    emit({"phase": "research_primitives", **rp_run["line"]})
    if rp_run["wrong"]:
        raise RuntimeError(f"{rp_run['wrong']} research-primitive outputs wrong")

    # 36-38. the core functions, multi-device (the batch mesh, the
    # poly-sharded PBS on K9, the latency route) and the C API over the port
    cf_run = core_functions_phase(kernels, p, args.seed + 130)
    emit({"phase": "core_functions", **cf_run["line"]})
    md_run = multi_device_phase(kernels, torus, ck, sk, served, ick, isk, args.seed + 131)
    emit({"phase": "multi_device", **md_run["line"]})
    capi_run = c_api_phase(kernels)
    emit({"phase": "c_api", **capi_run["line"]})
    for tag, run in (("core-function", cf_run), ("multi-device", md_run), ("C API", capi_run)):
        if run["wrong"]:
            raise RuntimeError(f"{run['wrong']} {tag} outputs wrong")

    # 34. kernels against their plain versions
    errs = {}
    k1 = keyswitch_check(served["cts"][0], sk, kernels, server, torus)
    k1_mb = keyswitch_check(mb_served["cts"][0], msk, kernels, server, torus)
    for tag, fig in (("k1", k1["fig"]), ("k1_multibit", k1_mb["fig"])):
        errs[tag] = fig["max_abs_err"] + fig["int_mm_max_abs_err"]
        errs[f"{tag}_generic_kernel_b{BATCH}"] = fig["generic_kernel_max_abs_err"]
    k1_rng = np.random.default_rng(args.seed + 6)
    # K1 at B = 1, as switch_modulus_and_compress launches it, on each key;
    # and the 512 values phase 10 stored on each key against the plain
    # keyswitch and modulus switch of the same ciphertexts
    for tag, s_key, fig in (("classic", sk, k1), ("multibit", msk, k1_mb)):
        q = s_key.params
        for b, ct in ((1, fig["ct"][:1]),
                      (BATCH + 1, torus.from_u64(k1_rng.integers(
                          0, 1 << 64, (BATCH + 1, fig["ct"].shape[1]), dtype=np.uint64), dev))):
            errs[f"k1_{tag}_b{b}"] = max_abs_err(
                kernels.keyswitch(ct, s_key.ks_key, q.ks_base_log, q.ks_level),
                server.keyswitch(ct, s_key.ksk, q.ks_base_log, q.ks_level))
        ks_mask, body, log_mod = switched_inputs(fig["want"], q, server)
        want = torch.cat([server.modulus_switch(ks_mask, log_mod), body[:, None]], dim=1)
        got = torus.from_u64(np.stack([c.switched() for c in ms_runs[tag]["stored"]]), dev)
        errs[f"k1_modswitch_stored_{tag}_b512"] = max_abs_err(got, want)

    # the kernels' choice by shape (csrc/keyswitch.cu imma_shape,
    # csrc/blind_rotate.cu exact_lazy_shape): K1's tensor-core kernel at the
    # keyswitch of every set of shortint/params.py, K2's lazy exact kernel at
    # exactly the classic sets of the V1_4 2_2 shape (k+1 = 2, N = 2048,
    # l = 1), the tensor-core kernel at the cast to small from the PKE set
    # (2^4 x 4) and the limb-row kernel at the cast to big (2^24 x 1); and
    # K1's wrapper on a shape outside the tensor-core guard (8-bit digits,
    # two byte limbs a digit) runs the limb-row kernel, against plain
    pke_d = shortint_params.V1_4_PARAM_PKE_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128.polynomial_size
    for name, q in vars(shortint_params).items():
        if isinstance(q, shortint_params.ShortintKeySwitchingParameters):
            if kernels.keyswitch_route(pke_d, q.ks_level, q.ks_base_log) != (
                    "imma" if q.destination_key == "small" else "limbs"):
                raise RuntimeError(f"K1 chose the wrong kernel for the cast {name}")
            continue
        if not isinstance(q, shortint_params.ShortintParams):
            continue
        if not kernels.keyswitch_imma_shape(q.big_lwe_dimension, q.ks_level, q.ks_base_log):
            raise RuntimeError(f"K1's tensor-core kernel refuses the keyswitch of {name}")
        lazy = (q.glwe_dimension == 1 and q.polynomial_size == 2048 and q.pbs_level == 1)
        if (not hasattr(q, "grouping_factor")
                and kernels.exact_lazy_shape(q.glwe_dimension + 1, q.polynomial_size,
                                             q.pbs_level, q.pbs_base_log) != lazy):
            raise RuntimeError(f"K2's exact rotation chose the wrong kernel for {name}")
    off = (torus.from_u64(k1_rng.integers(0, 1 << 64, (CHECK_BATCH, p.big_lwe_dimension + 1),
                                          dtype=np.uint64), dev),
           torus.from_u64(k1_rng.integers(0, 1 << 64, (p.big_lwe_dimension, 2,
                                                       p.lwe_dimension + 1),
                                          dtype=np.uint64), dev), 8, 2)
    limb_before = kernels.keyswitch.limb_launches
    off_key = kernels.keyswitch_key(off[1], 8, 2)
    errs[f"k1_limb_rows_wrapper_bl8_l2_b{CHECK_BATCH}"] = max_abs_err(
        kernels.keyswitch(off[0], off_key, 8, 2), server.keyswitch(*off))
    if kernels.keyswitch.limb_launches != limb_before + 1:
        raise RuntimeError("K1 did not take its limb-row kernel at base_log 8")

    # K1-32 at both KS32 shapes, and phase 25's plain comparisons
    errs.update(atomic_run["errs"])
    k132 = ks32_vs_plain(kernels, server, torus, atomic_run, k1_rng, errs)

    # K2 (v7 mode) on the classic path's round-0 switched inputs
    ks_mask, body, log_mod = switched_inputs(k1["want"], p, server)
    mask = server.modulus_switch(ks_mask, log_mod)
    lut_b = torus.from_u64(served["lut"].acc, dev).expand(BATCH, -1, -1)
    br_args = (mask, body, lut_b, sk.bsk_ntt, sk.dp, p.pbs_base_log,
               p.pbs_level, True)
    k2_got = kernels.blind_rotate(*br_args)
    t0 = time.perf_counter()
    k2_want = server.blind_rotate(*br_args)
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t0) * 1e3
    errs["k2_v7_b512"] = max_abs_err(k2_got, k2_want)
    k2_ms = cuda_ms(lambda: kernels.blind_rotate(*br_args), 3)
    k2_bound_v7 = k2_bound(mask, lut_b, p.pbs_level, p.pbs_base_log, V7_PRIMES)
    k2_bound_exact = k2_bound(mask, lut_b, p.pbs_level, p.pbs_base_log, EXACT_PRIMES)

    # the four-prime NTT key of round_bsk(bsk, 15): K2 in exact mode on it is
    # the function of tfhe_tpu's v3/v4 kernels (same inputs), and the
    # rounded-key route must give the words of the four-prime v7 rotation on it
    rounded4 = four_prime_rounded_key(sk._bsk_coeff, sk.bsk_ntt.round_bits, sk.dp)
    k2_rounded_exact_ms = cuda_ms(
        lambda: kernels.blind_rotate(*br_args[:3], rounded4, *br_args[4:7], False), 3)

    # K2 at B = 4, full n, random inputs, in both modes, in exact mode on
    # the rounded key, and the rounded-key route against the four-prime v7
    # rotation on the rounded key
    bsk_exact = sk.exact_bsk_ntt()
    if hasattr(bsk_exact, "round_bits") or not hasattr(sk.bsk_ntt, "round_bits"):
        raise RuntimeError("exact_bsk_ntt gave the rounded classic key")
    n_poly = p.polynomial_size
    chk = np.random.default_rng(args.seed + 2)
    m4 = torch.from_numpy(chk.integers(0, 2 * n_poly, (CHECK_BATCH, p.lwe_dimension))).to(dev)
    b4 = torch.from_numpy(chk.integers(0, 2 * n_poly, (CHECK_BATCH,))).to(dev)
    l4 = torus.from_u64(chk.integers(0, 1 << 64, (CHECK_BATCH, p.glwe_dimension + 1, n_poly),
                                     dtype=np.uint64), dev)
    # K2 in exact mode on the same B = 512 inputs and the unrounded key
    k2_exact_args = br_args[:3] + (bsk_exact,) + br_args[4:7] + (False,)
    k2_exact_got = kernels.blind_rotate(*k2_exact_args)
    t0 = time.perf_counter()
    k2_exact_want = server.blind_rotate(*k2_exact_args)
    torch.cuda.synchronize()
    k2_exact_plain_ms = (time.perf_counter() - t0) * 1e3
    errs["k2_exact_b512"] = max_abs_err(k2_exact_got, k2_exact_want)
    # phase 10's classic outputs came from the same switched values, LUT and
    # key through K2 in exact mode
    errs["k2_exact_modswitch_outputs_b512"] = max_abs_err(
        upload_batch([c.data for c in ms_runs["classic"]["outs"]], dev),
        server.sample_extract(k2_exact_want))
    del k2_exact_want
    k2_exact_ms = cuda_ms(lambda: kernels.blind_rotate(*k2_exact_args), 3)
    # the generic exact kernel on the same inputs: the kernel the lazy one
    # replaced at this shape
    generic_args = (kernels, server) + k2_exact_args[:7]
    errs["k2_exact_generic_kernel_b512"] = max_abs_err(
        generic_exact_rotation(*generic_args), k2_exact_got)
    k2_exact_generic_ms = cuda_ms(lambda: generic_exact_rotation(*generic_args), 3)
    del k2_exact_got
    # the lazy exact kernel over RAGGED_STEPS steps of the unrounded key at
    # batches its C ciphertexts a block do not fill
    for b in RAGGED_BATCHES:
        a = (torch.from_numpy(chk.integers(0, 2 * n_poly, (b, RAGGED_STEPS))).to(dev),
             torch.from_numpy(chk.integers(0, 2 * n_poly, (b,))).to(dev),
             torus.from_u64(chk.integers(0, 1 << 64, (b, p.glwe_dimension + 1, n_poly),
                                         dtype=np.uint64), dev),
             bsk_exact[:RAGGED_STEPS], sk.dp, p.pbs_base_log, p.pbs_level, False)
        errs[f"k2_exact_ragged_b{b}"] = max_abs_err(kernels.blind_rotate(*a),
                                                    server.blind_rotate(*a))
    # K2 at the TEST sets' shape and at 1_1's k + 1 = 5 on random keys (the
    # small-N cluster kernel at both; the wrapper must not take the lazy
    # kernel there)
    gen_g = torch.Generator(device=dev).manual_seed(args.seed + 7)
    for k1_g, n_g, l_g, bl_g in K2_GENERIC_SHAPES:
        dp_g = ntt.device_plan(ntt.make_plan(n_g, EXACT_PRIMES), "cuda")
        a = (torch.from_numpy(chk.integers(0, 2 * n_g, (CHECK_BATCH, K2_GENERIC_STEPS))).to(dev),
             torch.from_numpy(chk.integers(0, 2 * n_g, (CHECK_BATCH,))).to(dev),
             torus.from_u64(chk.integers(0, 1 << 64, (CHECK_BATCH, k1_g, n_g),
                                         dtype=np.uint64), dev),
             random_ntt_key((K2_GENERIC_STEPS, l_g, k1_g, k1_g), dp_g, gen_g), dp_g, bl_g, l_g,
             False)
        lazy_before = kernels.blind_rotate.lazy_exact_launches
        errs[f"k2_n512_exact_k{k1_g}_N{n_g}_b{CHECK_BATCH}"] = max_abs_err(
            kernels.blind_rotate(*a), server.blind_rotate(*a))
        if kernels.blind_rotate.lazy_exact_launches != lazy_before:
            raise RuntimeError(f"K2 took its lazy exact kernel at k+1 = {k1_g}, N = {n_g}")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    bsk_generic = random_ntt_key(
        (p.lwe_dimension, K2_GENERIC_LEVELS, p.glwe_dimension + 1, p.glwe_dimension + 1),
        sk.dp, gen)
    for mode, key, levels, trunc in (
            ("v7", sk.bsk_ntt, p.pbs_level, True),
            ("exact", bsk_exact, p.pbs_level, False),
            ("rounded_exact", rounded4, p.pbs_level, False),
            ("generic_exact", bsk_generic, K2_GENERIC_LEVELS, False)):
        a = (m4, b4, l4, key, sk.dp, p.pbs_base_log, levels, trunc)
        got, want = kernels.blind_rotate(*a), server.blind_rotate(*a)
        torch.cuda.synchronize()
        errs[f"k2_{mode}_b4"] = max_abs_err(got, want)
        if mode == "v7":
            errs["k2_v7_vs_four_prime_rounded_b4"] = max_abs_err(got, server.blind_rotate(
                m4, b4, l4, rounded4, sk.dp, p.pbs_base_log, levels, True))
    # v7 mode on the card takes only the rounded key: a four-prime one is refused
    try:
        kernels.blind_rotate(m4, b4, l4, rounded4, sk.dp, p.pbs_base_log, p.pbs_level, True)
        raise RuntimeError("K2 ran v7 mode on a four-prime key")
    except ValueError as exc:
        k2_v7_four_prime_refused = str(exc)
    del bsk_generic, rounded4
    # the rounded-key route over RAGGED_STEPS steps at batches its C
    # ciphertexts a block do not fill, and on a four-prime rounded key (the
    # CRT bound's fallback: rb = 4 at this base_log)
    ragged_key = head_of(sk.bsk_ntt, (RAGGED_STEPS,))
    for b in RAGGED_BATCHES:
        a = (torch.from_numpy(chk.integers(0, 2 * n_poly, (b, RAGGED_STEPS))).to(dev),
             torch.from_numpy(chk.integers(0, 2 * n_poly, (b,))).to(dev),
             torus.from_u64(chk.integers(0, 1 << 64, (b, p.glwe_dimension + 1, n_poly),
                                         dtype=np.uint64), dev),
             ragged_key, sk.dp, p.pbs_base_log, p.pbs_level, True)
        errs[f"k2_v7_ragged_b{b}"] = max_abs_err(kernels.blind_rotate(*a), server.blind_rotate(*a))
    coeff_head = sk._bsk_coeff.data[:RAGGED_STEPS]
    key4 = bsk_prep.rounded_key_ntt(coeff_head, 4, p.pbs_base_log, dev)
    if key4.num_primes != 4:
        raise RuntimeError("the CRT bound did not keep four primes at rb = 4")
    a = (m4[:3, :RAGGED_STEPS], b4[:3], l4[:3], key4, sk.dp, p.pbs_base_log, p.pbs_level, True)
    errs["k2_v7_four_prime_fallback_b3"] = max_abs_err(kernels.blind_rotate(*a),
                                                       server.blind_rotate(*a))
    errs["k2_v7_four_prime_fallback_vs_rounded_key_b3"] = max_abs_err(
        kernels.blind_rotate(*a), server.blind_rotate(
            *a[:3], four_prime_rounded_key(coeff_head, 4, sk.dp), *a[4:]))
    del ragged_key, key4

    # K2 in v7 mode at the decompression shape (n = k_c N_c = 1024) on all
    # 512 of phase 7's switched inputs, against the plain version (its time
    # is the 1024 steps' launches more than the batch: about as long at
    # B = 4)
    glwes_dev = torch.from_numpy(packed.glwes.astype(np.int64)).to(dev)
    msed = extract_switched(glwes_dev, list(range(BATCH)), cp.storage_log_modulus)
    lut_id = torus.from_u64(server.generate_lut(
        p.polynomial_size, p.glwe_dimension + 1, p.total_modulus, p.delta,
        lambda x: x), dev).expand(BATCH, -1, -1)
    dec_args = (msed[:, :-1], msed[:, -1], lut_id, dk.bsk_ntt, dk.dp, cp.br_base_log,
                cp.br_level, True)
    got = kernels.blind_rotate(*dec_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = server.blind_rotate(*dec_args)
    torch.cuda.synchronize()
    k2_dec_plain_ms = (time.perf_counter() - t0) * 1e3
    errs["k2_decompression_v7_b512"] = max_abs_err(got, want)
    errs["k2_decompression_outputs_b512"] = max_abs_err(
        upload_batch([c.data for c in dec_outs], dev), server.sample_extract(want))
    del got, want
    # the subset's B = 3 (a part-filled tile) the same way
    sub_msed = extract_switched(glwes_dev, subset, cp.storage_log_modulus)
    sub_args = (sub_msed[:, :-1], sub_msed[:, -1], lut_id[:len(subset)]) + dec_args[3:]
    sub_want = server.blind_rotate(*sub_args)
    errs["k2_decompression_v7_b3"] = max_abs_err(kernels.blind_rotate(*sub_args), sub_want)
    errs["k2_decompression_subset_outputs_b3"] = max_abs_err(
        upload_batch([c.data for c in sub_outs], dev), server.sample_extract(sub_want))
    # and the four-prime v7 rotation on the rounded decompression key
    dec4 = four_prime_rounded_key(dk._bsk_coeff, dk.bsk_ntt.round_bits, dk.dp)
    errs["k2_decompression_v7_vs_four_prime_rounded_b3"] = max_abs_err(
        sub_want, server.blind_rotate(*sub_args[:3], dec4, *sub_args[4:]))
    del dec4
    k2_dec_ms = cuda_ms(lambda: kernels.blind_rotate(*dec_args), 3)
    k2_dec_bound = k2_bound(msed[:, :-1], lut_id, cp.br_level, cp.br_base_log, V7_PRIMES)

    # K4 on phase 6's 512 inputs at the production shape: the tensor-core
    # kernel on the compression key's byte layout, which the wrapper must
    # take and a bare int64 key must not replace; the generic kernel it
    # replaced and the int8 torch._int_mm yardstick on the same inputs
    comp_in = upload_batch([ct.data for ct in chained], dev)
    pk_shape = (cp.packing_ks_base_log, cp.packing_ks_level, cp.lwe_per_glwe)
    k4_args = (comp_in, ckey.pks_key) + pk_shape
    plain_args = (comp_in, ckey.pksk) + pk_shape
    imma_before = kernels.packing_keyswitch.imma_launches
    k4_got = kernels.packing_keyswitch(*k4_args)
    if kernels.packing_keyswitch.imma_launches != imma_before + 1:
        raise RuntimeError("K4 did not take its tensor-core kernel at the V1_4 compression set")
    k4_want = server.packing_keyswitch(*plain_args)
    errs["k4_b512"] = max_abs_err(k4_got, k4_want)
    errs["k4_generic_kernel_b512"] = max_abs_err(
        generic_packing_keyswitch(kernels, *plain_args), k4_want)
    errs["k4_int_mm_yardstick_b512"] = max_abs_err(int_mm_packing_keyswitch(*plain_args),
                                                   k4_want)
    try:
        kernels.packing_keyswitch(*plain_args)
        k4_bare_key_refused = False
    except ValueError:
        k4_bare_key_refused = True
    if not k4_bare_key_refused:
        raise RuntimeError("K4's wrapper took a bare int64 key at the tensor-core shape")
    k4_ms = cuda_ms(lambda: kernels.packing_keyswitch(*k4_args), 20)
    k4_generic_ms = cuda_ms(lambda: generic_packing_keyswitch(kernels, *plain_args), 10)
    k4_plain_ms = cuda_ms(lambda: server.packing_keyswitch(*plain_args), 3)
    k4_library_ms = cuda_ms(lambda: int_mm_packing_keyswitch(*plain_args), 3)
    mm_ops = int_mm_operands(*plain_args)
    k4_library_gemm_ms = cuda_ms(lambda: int_mm_gemms(*mm_ops), 3)
    del mm_ops
    k4_b = k4_bound(comp_in, ckey.pksk, k4_got, cp.lwe_per_glwe, K4_PRIMES)
    pk_lib = kernels.load()["packing_keyswitch"]
    n_c = ckey.pksk.shape[0]
    k4_inputs = {b: pk_lib.tfhe_torch_packing_keyswitch_imma_inputs(
        n_c, cp.packing_ks_level, cp.packing_ks_base_log, b, cp.lwe_per_glwe)
        for b in (BATCH, K4_BIG_BATCH, K4_GUARD_BATCH)}
    # 16 GLWEs under the same key: the key read against the tensor cores
    big = torus.from_u64(chk.integers(0, 1 << 64, (K4_BIG_BATCH, n_c + 1), dtype=np.uint64),
                         dev)
    big_got = kernels.packing_keyswitch(big, ckey.pks_key, *pk_shape)
    errs[f"k4_b{K4_BIG_BATCH}"] = max_abs_err(big_got,
                                              server.packing_keyswitch(big, ckey.pksk, *pk_shape))
    k4_big = {"ms": cuda_ms(lambda: kernels.packing_keyswitch(big, ckey.pks_key, *pk_shape), 10),
              "generic_kernel_ms": cuda_ms(
                  lambda: generic_packing_keyswitch(kernels, big, ckey.pksk, *pk_shape), 3),
              "bound": k4_bound(big, ckey.pksk, big_got, cp.lwe_per_glwe, K4_PRIMES)}
    del big, big_got
    # the extreme limb sums: key words all ones, every mask word the one of
    # the largest digits (every GLWE then holds the same words); at B = 512
    # and at K4_GUARD_BATCH, where a block sums 3072 rows in s32
    word = extreme_mask_word(server, cp.packing_ks_base_log, cp.packing_ks_level)
    ones = torch.full_like(ckey.pksk, -1)
    ones_key = kernels.packing_keyswitch_key(ones, cp.packing_ks_base_log, cp.packing_ks_level)
    ones_want = server.packing_keyswitch(
        torch.full((cp.lwe_per_glwe, n_c + 1), word, dtype=torch.int64, device=dev), ones,
        *pk_shape)
    for b in (BATCH, K4_GUARD_BATCH):
        lw = torch.full((b, n_c + 1), word, dtype=torch.int64, device=dev)
        got = kernels.packing_keyswitch(lw, ones_key, *pk_shape)
        errs[f"k4_extreme_b{b}"] = max_abs_err(got, ones_want.expand_as(got))
    del ones, ones_key, lw, got
    # the kernel chosen by shape (csrc/packing_keyswitch.cu pk_imma_shape):
    # the tensor-core kernel at both compression sets; at K4_SHAPES each
    # kernel at the shapes it takes, the generic one also at the
    # tensor-core kernel's
    for q, cq in ((p, cp), (TEST_PARAMS, TEST_COMP_PARAM)):
        if not kernels.packing_keyswitch_imma_shape(
                q.big_lwe_dimension, cq.packing_ks_level, cq.packing_ks_glwe_dimension + 1,
                cq.packing_ks_polynomial_size, cq.packing_ks_base_log):
            raise RuntimeError("K4's tensor-core kernel refuses a compression set")
    for b, n_in, lev, k1_c, n_s, per, base_log in K4_SHAPES:
        lw = torus.from_u64(chk.integers(0, 1 << 64, (b, n_in + 1), dtype=np.uint64), dev)
        words = torus.from_u64(chk.integers(0, 1 << 64, (n_in, lev, k1_c, n_s),
                                            dtype=np.uint64), dev)
        imma = kernels.packing_keyswitch_imma_shape(n_in, lev, k1_c, n_s, base_log)
        key = kernels.packing_keyswitch_key(words, base_log, lev)
        if imma != isinstance(key, kernels.PackingKeyswitchKeyLimbs):
            raise RuntimeError("K4's key owner and wrapper disagree on the kernel")
        before = kernels.packing_keyswitch.imma_launches
        got = kernels.packing_keyswitch(lw, key, base_log, lev, per)
        if kernels.packing_keyswitch.imma_launches - before != int(imma):
            raise RuntimeError(f"K4 chose the wrong kernel at {(n_in, lev, k1_c, n_s, base_log)}")
        want = server.packing_keyswitch(lw, words, base_log, lev, per)
        tag = f"b{b}_n{n_in}_l{lev}_k{k1_c}_N{n_s}_per{per}_bl{base_log}"
        errs[f"k4_{'imma' if imma else 'generic'}_{tag}"] = max_abs_err(got, want)
        if imma:
            errs[f"k4_generic_{tag}"] = max_abs_err(
                generic_packing_keyswitch(kernels, lw, words, base_log, lev, per), want)

    # K3 (v9 mode) on the multi-bit path's round-0 switched inputs
    ks_mask, body, log_mod = switched_inputs(k1_mb["want"], mp, server)
    degrees = server.multibit_switched_degrees(ks_mask, mp.grouping_factor, log_mod)
    lut_mb = torus.from_u64(mb_served["lut"].acc, dev).expand(BATCH, -1, -1)
    k3_args = (degrees, body, lut_mb, msk.bsk_ntt, msk.dp, mp.pbs_base_log, mp.pbs_level)
    k3_got = kernels.blind_rotate_multibit(*k3_args, v9=True)
    t0 = time.perf_counter()
    k3_want = server.blind_rotate_multibit_v9(*k3_args)
    torch.cuda.synchronize()
    k3_plain_ms = (time.perf_counter() - t0) * 1e3
    errs["k3_v9_b512"] = max_abs_err(k3_got, k3_want)
    del k3_want
    k3_ms = cuda_ms(lambda: kernels.blind_rotate_multibit(*k3_args, v9=True), 3)
    k3_bound_v9 = k3_bound(degrees, lut_mb, mp.pbs_level, mp.pbs_base_log, V9_PRIMES, True)
    # the first CHECK_BATCH of them against the four-prime v9 rotation on
    # round_bsk(key, rb), the key K3 ran v9 mode on before the rounded-key route
    mb4 = four_prime_rounded_key(msk._bsk_coeff, msk.bsk_ntt.round_bits, msk.dp)
    errs[f"k3_v9_vs_four_prime_rounded_b{CHECK_BATCH}"] = max_abs_err(
        k3_got[:CHECK_BATCH], server.blind_rotate_multibit_v9(
            degrees[:CHECK_BATCH], body[:CHECK_BATCH], lut_mb[:CHECK_BATCH], mb4, msk.dp,
            mp.pbs_base_log, mp.pbs_level))
    del mb4
    # the rounded-key route over RAGGED_GROUPS groups at batches its C
    # ciphertexts a block do not fill, and on a four-prime rounded key
    # (rb = 4: the CRT bound's fallback)
    ragged_key = head_of(msk.bsk_ntt, (RAGGED_GROUPS, 1 << mp.grouping_factor))
    for b in RAGGED_BATCHES:
        raw = torus.from_u64(chk.integers(0, 1 << 64, (b, RAGGED_GROUPS * mp.grouping_factor),
                                          dtype=np.uint64), dev)
        a = (server.multibit_switched_degrees(raw, mp.grouping_factor, log_mod),
             torch.from_numpy(chk.integers(0, 2 * n_poly, (b,))).to(dev),
             torus.from_u64(chk.integers(0, 1 << 64, (b, mp.glwe_dimension + 1, n_poly),
                                         dtype=np.uint64), dev),
             ragged_key, msk.dp, mp.pbs_base_log, mp.pbs_level)
        errs[f"k3_v9_ragged_b{b}"] = max_abs_err(kernels.blind_rotate_multibit(*a, v9=True),
                                                 server.blind_rotate_multibit_v9(*a))
    coeff_head = msk._bsk_coeff[:RAGGED_GROUPS]
    key4 = bsk_prep.rounded_key_ntt(coeff_head, 4, mp.pbs_base_log, dev, mp.grouping_factor)
    if key4.num_primes != 4:
        raise RuntimeError("the multi-bit CRT bound did not keep four primes at rb = 4")
    a = (a[0][:3], a[1][:3], a[2][:3], key4, msk.dp, mp.pbs_base_log, mp.pbs_level)
    got = kernels.blind_rotate_multibit(*a, v9=True)
    errs["k3_v9_four_prime_fallback_b3"] = max_abs_err(got, server.blind_rotate_multibit_v9(*a))
    errs["k3_v9_four_prime_fallback_vs_rounded_key_b3"] = max_abs_err(
        got, server.blind_rotate_multibit_v9(
            *a[:3], four_prime_rounded_key(coeff_head, 4, msk.dp), *a[4:]))
    del ragged_key, key4

    # K3 in exact mode on the same B = 512 inputs and the unrounded key
    mb_exact = msk.exact_bsk_ntt()
    if hasattr(mb_exact, "round_bits") or not hasattr(msk.bsk_ntt, "round_bits"):
        raise RuntimeError("exact_bsk_ntt gave the rounded multi-bit key")
    k3_exact_args = k3_args[:3] + (mb_exact,) + k3_args[4:]
    k3_exact_got = kernels.blind_rotate_multibit(*k3_exact_args, v9=False)
    t0 = time.perf_counter()
    k3_exact_want = server.blind_rotate_multibit(*k3_exact_args)
    torch.cuda.synchronize()
    k3_exact_plain_ms = (time.perf_counter() - t0) * 1e3
    errs["k3_exact_b512"] = max_abs_err(k3_exact_got, k3_exact_want)
    del k3_exact_want
    k3_exact_ms = cuda_ms(lambda: kernels.blind_rotate_multibit(*k3_exact_args, v9=False), 3)
    k3_bound_exact = k3_bound(degrees, lut_mb, mp.pbs_level, mp.pbs_base_log,
                              EXACT_PRIMES, False)
    # phase 10's multi-bit outputs: the stored values' pattern degrees
    # (raw=False) through the plain exact rotation, same LUT and key
    st = torus.from_u64(np.stack([c.switched() for c in ms_runs["multibit"]["stored"]]), dev)
    deg_st = server.multibit_switched_degrees(st[:, :-1], mp.grouping_factor, log_mod,
                                              raw=False)
    errs["k3_exact_modswitch_outputs_b512"] = max_abs_err(
        upload_batch([c.data for c in ms_runs["multibit"]["outs"]], dev),
        server.sample_extract(server.blind_rotate_multibit(
            deg_st, st[:, -1], lut_mb, mb_exact, msk.dp, mp.pbs_base_log, mp.pbs_level)))
    # the exact kernel over RAGGED_GROUPS groups of the unrounded key at
    # batches its C ciphertexts a block do not fill
    for b in RAGGED_BATCHES:
        raw = torus.from_u64(chk.integers(0, 1 << 64, (b, RAGGED_GROUPS * mp.grouping_factor),
                                          dtype=np.uint64), dev)
        a = (server.multibit_switched_degrees(raw, mp.grouping_factor, log_mod),
             torch.from_numpy(chk.integers(0, 2 * n_poly, (b,))).to(dev),
             torus.from_u64(chk.integers(0, 1 << 64, (b, mp.glwe_dimension + 1, n_poly),
                                         dtype=np.uint64), dev),
             mb_exact[:RAGGED_GROUPS], msk.dp, mp.pbs_base_log, mp.pbs_level)
        errs[f"k3_exact_ragged_b{b}"] = max_abs_err(kernels.blind_rotate_multibit(*a, v9=False),
                                                    server.blind_rotate_multibit(*a))
    del mb_exact

    # K3 at other shapes on random keys and inputs: tfhe_tpu's GROUP_2 set
    # (g = 2, n = 918) in exact mode (the specialised instance) and in v9
    # mode on a rounded key (rb = mb_round_bits, its rounded-key kernel at
    # four patterns a group), and the GROUP_3 shape (l = 2: the cluster
    # kernel) in exact mode, the only mode that set runs on the card; v9
    # mode must refuse a rounded key of its shape and, on the card, a
    # four-prime key
    k3_shapes = {}
    for tag, q, base_log in (("tpu_group_2", TPU_GROUP_2, TPU_GROUP_2.pbs_base_log),
                             ("group_3", GROUP_3, GROUP_3.pbs_base_log)):
        g, n_groups = q.grouping_factor, q.lwe_dimension // q.grouping_factor
        key = random_ntt_key((n_groups, 1 << g, q.pbs_level, 2, 2), msk.dp, gen)
        raw = torus.from_u64(chk.integers(0, 1 << 64, (CHECK_BATCH, q.lwe_dimension),
                                          dtype=np.uint64), dev)
        deg_q = server.multibit_switched_degrees(raw, g, log_mod)
        a = (deg_q, b4, l4, key, msk.dp, base_log, q.pbs_level)
        errs[f"k3_{tag}_exact_b4"] = max_abs_err(kernels.blind_rotate_multibit(*a, v9=False),
                                                 server.blind_rotate_multibit(*a))
        rounded_q = bsk_prep.rounded_key_ntt(
            chk.integers(0, 1 << 64, (n_groups, 1 << g, q.pbs_level, 2, 2, n_poly),
                         dtype=np.uint64), bsk_prep.mb_round_bits(q), base_log, dev, g)
        a = (deg_q, b4, l4, rounded_q, msk.dp, base_log, q.pbs_level)
        if tag == "tpu_group_2":
            errs[f"k3_{tag}_v9_b4"] = max_abs_err(kernels.blind_rotate_multibit(*a, v9=True),
                                                  server.blind_rotate_multibit_v9(*a))
        else:
            for refused, args_q in (("rounded_key", a), ("four_prime_key", a[:3] + (key,) + a[4:])):
                try:
                    kernels.blind_rotate_multibit(*args_q, v9=True)
                    raise RuntimeError(f"K3 took v9 mode on a {refused} at l = 2")
                except ValueError as exc:
                    k3_shapes[f"group_3_v9_{refused}_refused"] = str(exc)
        del key, rounded_q
    # K3's exact route: the wrapper's predicate against the cluster
    # kernel's own (csrc/blind_rotate_multibit_cluster.cu mb_cluster_shape)
    # at every multi-bit set's shape
    c_shape = kernels.load()["blind_rotate_multibit_cluster"].tfhe_torch_blind_rotate_multibit_cluster_shape
    for q in vars(shortint_mod.params).values():
        if isinstance(q, shortint_mod.params.MultiBitPBSParameters):
            shape = (q.glwe_dimension + 1, q.polynomial_size, q.pbs_level, q.grouping_factor,
                     q.pbs_base_log)
            if kernels.multibit_cluster_shape(*shape) != bool(
                    c_shape(shape[0], shape[1].bit_length() - 1, *shape[2:])):
                raise RuntimeError(f"K3's cluster-shape predicates disagree at {shape}")

    # K5 on the squash phase's own inputs (the plain keyswitch and modulus
    # switch of the chained outputs): all 512 against the phase's outputs,
    # and the first K5_PLAIN_BATCH against the plain u128 rotation
    sq_in = upload_batch([ct.data for ct in chained], dev)
    ks = server.keyswitch(sq_in, sk.ksk, p.ks_base_log, p.ks_level)
    log_mod_sq = sqp.polynomial_size.bit_length()
    sq_lut = tuple(t.expand((BATCH,) + tuple(t.shape)) for t in nsk._lut)
    k5_args = (server.modulus_switch(ks[:, :-1], log_mod_sq),
               server.modulus_switch(ks[:, -1], log_mod_sq)) + sq_lut + (
        nsk.bsk128_ntt, nsk.dp128, sqp.decomp_base_log, sqp.decomp_level_count)
    k5_lo, k5_hi = kernels.blind_rotate128(*k5_args)
    se_lo, se_hi = server128.sample_extract128(k5_lo, k5_hi)
    errs["k5_squash_outputs_lo_b512"] = max_abs_err(torch.stack([sq.lo for sq in squashed]), se_lo)
    errs["k5_squash_outputs_hi_b512"] = max_abs_err(torch.stack([sq.hi for sq in squashed]), se_hi)
    k5_sub = tuple(a[:K5_PLAIN_BATCH] for a in k5_args[:4]) + k5_args[4:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_lo, want_hi = server128.blind_rotate128(*k5_sub)
    torch.cuda.synchronize()
    k5_plain_ms = (time.perf_counter() - t0) * 1e3
    errs[f"k5_lo_b{K5_PLAIN_BATCH}"] = max_abs_err(k5_lo[:K5_PLAIN_BATCH], want_lo)
    errs[f"k5_hi_b{K5_PLAIN_BATCH}"] = max_abs_err(k5_hi[:K5_PLAIN_BATCH], want_hi)
    del want_lo, want_hi, se_lo, se_hi
    k5_ms = cuda_ms(lambda: kernels.blind_rotate128(*k5_args), 3)
    k5_b = k5_bound(k5_args[0], sq_lut[0], sqp.decomp_level_count, sqp.decomp_base_log)
    # K5 at the TEST squashing shape (k + 1 = 2, N = 512, the generic
    # instance) on a random 6-prime key
    n_t, k1_t = SQ_TEST.polynomial_size, SQ_TEST.glwe_dimension + 1
    dp_t = ntt.device_plan(ntt.make_plan(n_t, K5_PRIMES), "cuda")
    t_args = (torch.from_numpy(chk.integers(0, 2 * n_t, (CHECK_BATCH, K5_TEST_STEPS))).to(dev),
              torch.from_numpy(chk.integers(0, 2 * n_t, (CHECK_BATCH,))).to(dev)) + tuple(
        torus.from_u64(chk.integers(0, 1 << 64, (CHECK_BATCH, k1_t, n_t), dtype=np.uint64), dev)
        for _ in range(2)) + (
        random_ntt_key((K5_TEST_STEPS, SQ_TEST.decomp_level_count, k1_t, k1_t), dp_t, gen),
        dp_t, SQ_TEST.decomp_base_log, SQ_TEST.decomp_level_count)
    got, want = kernels.blind_rotate128(*t_args), server128.blind_rotate128(*t_args)
    errs[f"k5_test_shape_b{CHECK_BATCH}"] = max(max_abs_err(g, w) for g, w in zip(got, want))
    k1_g, n_g, l_g, bl_g = K5_GENERIC_SHAPE
    dp_g = ntt.device_plan(ntt.make_plan(n_g, K5_PRIMES), "cuda")
    g_args = (torch.from_numpy(chk.integers(0, 2 * n_g, (CHECK_BATCH, K5_TEST_STEPS))).to(dev),
              torch.from_numpy(chk.integers(0, 2 * n_g, (CHECK_BATCH,))).to(dev)) + tuple(
        torus.from_u64(chk.integers(0, 1 << 64, (CHECK_BATCH, k1_g, n_g), dtype=np.uint64), dev)
        for _ in range(2)) + (
        random_ntt_key((K5_TEST_STEPS, l_g, k1_g, k1_g), dp_g, gen), dp_g, bl_g, l_g)
    got, want = kernels.blind_rotate128(*g_args), server128.blind_rotate128(*g_args)
    errs[f"k5_generic_shape_b{CHECK_BATCH}"] = max(max_abs_err(g, w) for g, w in zip(got, want))
    # the squashing key's first K5_RAGGED_STEPS steps at the ragged batches
    for b in RAGGED_BATCHES:
        a = (torch.from_numpy(chk.integers(0, 2 * sqp.polynomial_size,
                                           (b, K5_RAGGED_STEPS))).to(dev),
             torch.from_numpy(chk.integers(0, 2 * sqp.polynomial_size, (b,))).to(dev)) + tuple(
            torus.from_u64(chk.integers(0, 1 << 64, (b, k1_sq, sqp.polynomial_size),
                                        dtype=np.uint64), dev) for _ in range(2)) + (
            nsk.bsk128_ntt[:K5_RAGGED_STEPS], nsk.dp128, sqp.decomp_base_log,
            sqp.decomp_level_count)
        got, want = kernels.blind_rotate128(*a), server128.blind_rotate128(*a)
        errs[f"k5_ragged_b{b}"] = max(max_abs_err(g, w) for g, w in zip(got, want))

    # K2's single-step entry: phase 13's stepwise rotation against the whole
    # K2 rotation and the plain one (exact mode), and one step at B = 512
    errs["k2_step_vs_whole_k2_b512"] = max_abs_err(stepwise, kernels.blind_rotate(*st_args, False))
    t0 = time.perf_counter()
    errs["k2_step_vs_plain_b512"] = max_abs_err(stepwise, server.blind_rotate(*st_args, False))
    torch.cuda.synchronize()
    k2_step_plain_rotation_ms = (time.perf_counter() - t0) * 1e3
    acc0 = server.initial_accumulator(st_args[2], st_args[1], False).contiguous()
    step_args = (st_args[0][:, 0], st_args[3][0]) + st_args[4:]
    errs["k2_step_single_b512"] = max_abs_err(kernels.cmux_step(acc0.clone(), *step_args),
                                              server.cmux_step(acc0, *step_args))
    for b in RAGGED_BATCHES:
        acc_b = torus.from_u64(chk.integers(0, 1 << 64, (b, glwe_size, n_poly),
                                            dtype=np.uint64), dev)
        a_b = torch.from_numpy(chk.integers(0, 2 * n_poly, (b,))).to(dev)
        errs[f"k2_step_ragged_b{b}"] = max_abs_err(
            kernels.cmux_step(acc_b.clone(), a_b, *step_args[1:]),
            server.cmux_step(acc_b, a_b, *step_args[1:]))
    k2_step_ms = cuda_ms(lambda: kernels.cmux_step(acc0, *step_args), 10)
    step_probe_after = step_entry_probe(kernels, server, st_args)
    k2_step_plain_ms = cuda_ms(lambda: server.cmux_step(acc0, *step_args), 3)
    k2_step_bound = k2_bound(st_args[0][:, :1], st_args[2], p.pbs_level, p.pbs_base_log,
                             EXACT_PRIMES)
    # phase 14's FheUint64 mul product round, phase 17's packed gates and
    # K2's generic exact kernel at the TFHE_LIB shape
    k2_bool = integer_boolean_vs_plain(kernels, server, ntt, torus, p, sk,
                                       integer_run["product_round"], boolean_run, chk, gen_g,
                                       errs)
    # phase 19's OPRF draw and phase 22's first string round
    hlapi_paths_vs_plain(kernels, server, torus, hl_sk, oprf_run["seed"], oprf_run["draw"],
                         str_run["first_round"], errs)
    # phase 23's casts: K1 at both cast shapes, K2's lazy exact kernel at B = 64
    cast_figs = compact_paths_vs_plain(kernels, server, torus, hl_sk, pke_run, errs)
    # phases 27-28: K6, K1 at the PFPKS shape, K2's CMux entry
    s13 = slice13_vs_plain(kernels, server, server128, sqc_run, wopbs_run, args.seed + 93, errs)
    # phases 31-32: K2's cluster kernel at the 3_3 shape, the new sets' rounds
    s14 = cluster_figures(kernels, server, torus, s33_run, args.seed + 101, errs)
    errs.update(ps_run["errs"])
    s18 = param_sets_vs_plain(kernels, server, ps_run, errs)
    del ps_run["keys"]
    # phase 33: K7 at both signs, K1 at the shrinking and CM shapes, K8 at
    # E = 1, 2, 4 and K2 at the CM shape
    s15 = research_vs_plain(kernels, server, torus, rp_run["run"], p, args.seed + 121, errs)
    for e in EXT_FACTORS:
        chosen = (e, rp_run["line"][f"extended_pbs_e{e}"]["slots_per_block"])
        if chosen not in s15["k8_slots_held"]:
            raise RuntimeError(f"K8's lazy kernel at (E, slots a block) {chosen}, as phase 33 "
                               f"ran it, was not held against its plain version")
    # phases 28-29: K2 at the TEST shapes as they launched it, and its small-N
    # cluster kernel (the rotation, the CMux chain) against the generic kernel
    s16 = test_shape_figures(kernels, server, torus, test_shapes.shapes, args.seed + 122, errs)
    s17 = small_n_vs_plain(kernels, server, torus, args.seed + 123, errs)
    # phase 37: K9's three entries at the poly path's shapes
    s21 = k9_vs_plain(kernels, torus, sk, args.seed + 132, errs)
    s22 = k9_rotate_vs_plain(kernels, sk, args.seed + 133, errs)
    torch.cuda.synchronize()
    emit({"phase": "kernels_vs_plain", "tolerance": 0,
          **{f"{name}_max_abs_err": err for name, err in errs.items()},
          "k2_generic_levels": K2_GENERIC_LEVELS,
          "k2_v7_four_prime_key_refused": k2_v7_four_prime_refused,
          "k4_bare_key_refused": k4_bare_key_refused, **k3_shapes})
    if any(errs.values()):
        raise RuntimeError("a kernel disagrees with its plain version")

    # 35. launches of the paths (phases 4, 6, 7, 9, 10, 12, 13, 14-24,
    # 27-32) and the kernel table
    int_lines = integer_run["line"]
    int_paths = {"integer": [op for group in ("fheuint64", "fheuint8", "batched_fheuint64")
                             for op in int_lines[group].values()],
                 "integer_multibit": list(mb_integer_line["fheuint64"].values()),
                 "integer_storage": [storage_line[k] for k in STORAGE_STEPS],
                 "boolean": [boolean_run["line"][k] for k in ("and", "packed", "mux")],
                 "hlapi": (list(hl_run["line"]["fheuint64"].values())
                           + [hl_run["line"]["squash_noise"]]),
                 "oprf": [oprf_run["line"][k] for k in HLAPI_OPRF_STEPS],
                 "compressed_key": [ckey_run["line"]["fheuint64_add"]],
                 "kv_store": [kv_run["line"][k] for k in HLAPI_KV_STEPS],
                 "strings": [str_run["line"][k] for k in HLAPI_STRING_OPS],
                 "compact_pke": ([{"launches": v} for v in pke_run["line"]["launches"].values()]
                                 + [pke_run["line"]["fheuint64_add"]]),
                 "trivium": [triv_run["line"][name][tag] for name, _, _ in TRIVIUM_STREAMS
                             for tag in ("keystream", "transcipher")]}

    # phases 27-30, by path
    sqc_l, wop_l, aes_l = sqc_run["line"], wopbs_run["line"], aes_run["line"]
    s13_paths = {
        "squash_compress": {"one_list": sqc_l["one_list"]["launches"],
                            "fheuint64": sqc_l["fheuint64"]["launches"],
                            "four_lists": sqc_l["four_lists"]["launches"]},
        "wopbs": {"extract_bits": wop_l["extract_bits"]["launches"],
                  **{f"apply_wopbs_{k}": v["launches"] for k, v in wop_l["apply_wopbs"].items()},
                  "vertical_packing": wop_l["vertical_packing"]["launches"]},
        "aes": {"sbox": aes_l["sbox"]["launches"],
                "aes128_round": aes_l["aes128_round"]["launches"]},
        "test_vectors": {"both_sets": tv_run["line"]["launches"]}}

    def s13_launches(counter: str, paths=None) -> dict:
        """Launches of one counter on each path of phases 27-30."""
        return {path: sum(run.get(counter, 0) for run in runs.values())
                for path, runs in s13_paths.items() if paths is None or path in paths}

    def path_launches(counter: str) -> dict:
        """Launches of one counter on each integer and boolean path."""
        return {path: sum(op["launches"].get(counter, 0) for op in ops)
                for path, ops in int_paths.items()}

    emit({"phase": "launches", "serve": launches, "serve_multibit": mb_launches,
          "rounds": ROUNDS + 2, "compress": comp_launches, "decompress": decomp_launches,
          "decompress_subset": sub_launches, "modswitch_compress": ms_launches,
          "squash": sq_launches, "stepwise": st_launches,
          "integer": {f"{group}_{name}": op["launches"]
                      for group in ("fheuint64", "fheuint8", "batched_fheuint64")
                      for name, op in int_lines[group].items()},
          "integer_multibit": {name: op["launches"]
                               for name, op in mb_integer_line["fheuint64"].items()},
          "integer_storage": {k: storage_line[k]["launches"] for k in STORAGE_STEPS},
          "boolean": {k: boolean_run["line"][k]["launches"] for k in ("and", "packed", "mux")},
          "hlapi": {**{k: op["launches"] for k, op in hl_run["line"]["fheuint64"].items()},
                    "squash_noise": hl_run["line"]["squash_noise"]["launches"]},
          "oprf": {k: oprf_run["line"][k]["launches"] for k in HLAPI_OPRF_STEPS},
          "compressed_key": {"fheuint64_add": ckey_run["line"]["fheuint64_add"]["launches"]},
          "kv_store": {k: kv_run["line"][k]["launches"] for k in HLAPI_KV_STEPS},
          "strings": {k: str_run["line"][k]["launches"] for k in HLAPI_STRING_OPS},
          "compact_pke": {**pke_run["line"]["launches"],
                          "fheuint64_add": pke_run["line"]["fheuint64_add"]["launches"]},
          "trivium": {f"{name}_{tag}": triv_run["line"][name][tag]["launches"]
                      for name, _, _ in TRIVIUM_STREAMS for tag in ("keystream", "transcipher")},
          **s13_paths, "serve_3_3": s33_run["line"]["launches"],
          "serve_3_3_radix": {k: s33_run["line"]["radix"][k]["launches"] for k in ("add", "mul")},
          "param_sets": {f"{t}{suffix}": ps_run["line"][t][key] for t, *_ in PARAM_SETS
                         for suffix, key in PARAM_SETS_RUNS},
          "research_primitives": {t: rp_run["line"][t]["launches"] for t in RESEARCH_STEPS}})
    ks_paths, ks_imma_paths = path_launches("keyswitch"), path_launches("keyswitch_imma")
    ks_limb_paths = path_launches("keyswitch_limbs")
    br_paths, lazy_paths = path_launches("blind_rotate"), path_launches("blind_rotate_exact_lazy")
    mb_paths, k5_paths = path_launches("blind_rotate_multibit"), path_launches("blind_rotate128")
    # K2's launches in v7 mode on the hlapi paths (the OPRF's and the casts'
    # are exact)
    hl_v7 = {path: br_paths[path] - lazy_paths[path] for path in HLAPI_PATHS + ("compact_pke",)}
    hl_lazy = {path: lazy_paths[path] for path in HLAPI_PATHS + ("compact_pke",)
               if lazy_paths[path]}
    # K2's CMux entry by path (phases 28-30, 33) and by route
    rp_cmux = rp_run["run"]["cm_cmux"]
    rp_cmux_runs = {t: rp_run["line"][t]["launches"] for t in RESEARCH_STEPS
                    if t.startswith("cm_cmux") or t.startswith("cm_external_product")}
    cmux_paths = {**s13_launches("cmux"), "research_primitives": sum(
        r.get("cmux", 0) for r in rp_cmux_runs.values())}
    cmux_routes = {route: sum(s13_launches(f"cmux_{route}").values()) + sum(
        r.get(f"cmux_{route}", 0) for r in rp_cmux_runs.values())
        for route in ("small", "cluster")}
    cmux_routes["generic"] = sum(cmux_paths.values()) - sum(cmux_routes.values())
    emit({"phase": "total", "seconds": time.perf_counter() - started})
    print(card, flush=True)
    table = [
        {"name": "keyswitch", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/keyswitch.cu",
         "replaces": "tfhe_tpu/ops/server.py:84",
         "kernel": "keyswitch_imma_kernel (int8 tensor cores; keyswitch_limbs_kernel at the "
                   "wide-digit shapes, keyswitch_kernel elsewhere)",
         "launches": (launches["keyswitch"] + mb_launches["keyswitch"]
                      + sq_launches["keyswitch"] + sum(ks_paths.values())),
         "launches_by_path": {
             "serve": launches["keyswitch"], "serve_multibit": mb_launches["keyswitch"],
             "squash": sq_launches["keyswitch"],
             "modswitch_compress_classic": ms_launches["classic"]["switch"]["keyswitch"],
             "modswitch_compress_multibit": ms_launches["multibit"]["switch"]["keyswitch"],
             **ks_paths},
         "tensor_core_launches_by_path": {
             "serve": launches["keyswitch_imma"], "serve_multibit": mb_launches["keyswitch_imma"],
             "squash": sq_launches["keyswitch_imma"],
             "modswitch_compress_classic": ms_launches["classic"]["switch"]["keyswitch_imma"],
             "modswitch_compress_multibit":
                 ms_launches["multibit"]["switch"]["keyswitch_imma"], **ks_imma_paths},
         "max_abs_err": max(v for k, v in errs.items() if k.startswith("k1")),
         "ms": k1["fig"]["ms"], "plain_ms": k1["fig"]["plain_ms"],
         "generic_kernel_ms": k1["fig"]["generic_kernel_ms"],
         "multibit_generic_kernel_ms": k1_mb["fig"]["generic_kernel_ms"],
         "bound_ms": k1["fig"]["bound_ms"], "bound_by": k1["fig"]["bound_by"],
         "library_ms": k1["fig"]["library_ms"],
         "library_call": "10 int8-limb torch._int_mm GEMMs (the TPU's formulation)",
         "shape": k1["fig"]["shape"],
         "multibit_shape": k1_mb["fig"]["shape"], "multibit_ms": k1_mb["fig"]["ms"],
         "multibit_plain_ms": k1_mb["fig"]["plain_ms"],
         "multibit_bound_ms": k1_mb["fig"]["bound_ms"],
         "multibit_bound_by": k1_mb["fig"]["bound_by"],
         "multibit_library_ms": k1_mb["fig"]["library_ms"],
         "cast_shapes": {tag: {k: v for k, v in fig.items() if k != "k2_exact"}
                         for tag, fig in cast_figs.items()},
         "cast_launches": {k: pke_run["line"]["launches"][k]["keyswitch"]
                           for k in ("cast_small_b64", "cast_small_full", "cast_big_b32")},
         "limb_row_launches_by_path": {path: n for path, n in ks_limb_paths.items() if n},
         "generic_launches_by_path": {
             path: ks_paths[path] - ks_imma_paths[path] - ks_limb_paths[path]
             for path in ks_paths
             if ks_paths[path] != ks_imma_paths[path] + ks_limb_paths[path]}},
        {"name": "blind_rotate", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate.cu",
         "replaces": "tfhe_tpu/ops/pallas_mxu.py:1289",
         "kernel": "blind_rotate_rounded_kernel (v7 mode)",
         "launches": launches["blind_rotate"] + br_paths["integer"] + sum(hl_v7.values()),
         "launches_by_path": {"serve": launches["blind_rotate"],
                              "integer": br_paths["integer"], **hl_v7},
         "max_abs_err": max(v for k, v in errs.items() if k.startswith("k2")
                            and "decompression" not in k and "step" not in k
                            and not k.startswith(("k2_exact", "k2_generic",
                                                  "k2_rounded_exact"))),
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound_v7["ms"], "bound_by": k2_bound_v7["by"],
         "library_ms": None,
         "bound_primes": V7_PRIMES,
         "bound_ntt_int32_ms": k2_bound_v7["ntt_ms"],
         "bound_four_step_int8_ms": k2_bound_v7["four_step_ms"],
         "bound_bytes_ms": k2_bound_v7["bytes_ms"],
         "shape": [BATCH, p.lwe_dimension, p.glwe_dimension + 1, p.polynomial_size]},
        {"name": "blind_rotate_exact", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate.cu",
         "replaces": "tfhe_tpu/ops/pallas_ntt.py:794",
         "also_replaces_rows_4_5_7": ["tfhe_tpu/ops/pallas_mxu.py:428",
                                      "tfhe_tpu/ops/pallas_mxu.py:809",
                                      "tfhe_tpu/ops/pallas_ntt.py:456"],
         "kernel": "blind_rotate_exact_lazy_kernel (k+1 = 2, l = 1, N = 2048; "
                   "blind_rotate_kernel at other shapes)",
         "launches": (ms_launches["classic"]["decompress"]["blind_rotate_exact_lazy"]
                      + st_launches["cmux_step_exact_lazy"] + lazy_paths["integer_storage"]
                      + lazy_paths["boolean"] + lazy_paths["trivium"]
                      + sum(hl_lazy.values())),
         "launches_by_path": {
             "modswitch_compress_classic":
                 ms_launches["classic"]["decompress"]["blind_rotate_exact_lazy"],
             "stepwise": st_launches["cmux_step_exact_lazy"],
             "integer_storage": lazy_paths["integer_storage"], "boolean": lazy_paths["boolean"],
             "trivium": lazy_paths["trivium"], **hl_lazy},
         "cast": {f"b{PKE_SLOTS * 2}": cast_figs["small_b64"]["k2_exact"],
                  f"b{PKE_FULL_SLOTS}": cast_figs[f"small_b{PKE_FULL_SLOTS}"]["k2_exact"],
                  "launches": {k: pke_run["line"]["launches"][k]["blind_rotate_exact_lazy"]
                               for k in ("cast_small_b64", "cast_small_full")}},
         "boolean_ms": k2_bool["ms"], "boolean_plain_ms": k2_bool["plain_ms"],
         "boolean_bound_ms": k2_bool["bound"]["ms"], "boolean_shape": k2_bool["shape"],
         "max_abs_err": max(v for k, v in errs.items() if k.startswith(("k2_exact",
                                                                         "k2_generic",
                                                                         "k2_rounded_exact"))),
         "ms": k2_exact_ms, "plain_ms": k2_exact_plain_ms,
         "generic_kernel_ms": k2_exact_generic_ms,
         "rounded_key_ms": k2_rounded_exact_ms,
         "bound_ms": k2_bound_exact["ms"], "bound_by": k2_bound_exact["by"],
         "library_ms": None,
         "library_call": "none: no PyTorch call computes an exact wrapping-u64 "
                         "negacyclic product",
         "bound_primes": EXACT_PRIMES,
         "bound_ntt_int32_ms": k2_bound_exact["ntt_ms"],
         "bound_four_step_int8_ms": k2_bound_exact["four_step_ms"],
         "bound_bytes_ms": k2_bound_exact["bytes_ms"],
         "ciphertexts_per_block": kernels.exact_cts_per_block(),
         "shape": [BATCH, p.lwe_dimension, p.glwe_dimension + 1, p.polynomial_size]},
        {"name": "blind_rotate_multibit", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate_multibit.cu",
         "replaces": "tfhe_tpu/ops/pallas_mxu.py:2631",
         "also_replaces": "tfhe_tpu/ops/pallas_mxu.py:2178",
         "launches": mb_launches["blind_rotate_multibit"] + mb_paths["integer_multibit"],
         "launches_by_path": {
             "serve_multibit": mb_launches["blind_rotate_multibit"],
             "modswitch_compress_multibit":
                 ms_launches["multibit"]["decompress"]["blind_rotate_multibit"],
             "integer_multibit": mb_paths["integer_multibit"]},
         "max_abs_err": max(v for k, v in errs.items()
                            if k.startswith("k3") and not k.startswith("k3_exact")),
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound_v9["ms"], "bound_by": k3_bound_v9["by"],
         "library_ms": None,
         "bound_primes": V9_PRIMES,
         "bound_ntt_int32_ms": k3_bound_v9["ntt_ms"],
         "bound_four_step_int8_ms": k3_bound_v9["four_step_ms"],
         "bound_bytes_ms": k3_bound_v9["bytes_ms"],
         "shape": [BATCH, mp.lwe_dimension // mp.grouping_factor,
                   1 << mp.grouping_factor, mp.glwe_dimension + 1, mp.polynomial_size]},
        {"name": "blind_rotate_multibit_exact", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate_multibit.cu",
         "replaces": "tfhe_tpu/ops/server.py:425",
         "launches": ms_launches["multibit"]["decompress"]["blind_rotate_multibit"],
         "launches_by_path": {
             "modswitch_compress_multibit":
                 ms_launches["multibit"]["decompress"]["blind_rotate_multibit"]},
         "max_abs_err": max(v for k, v in errs.items() if k.startswith("k3_exact")
                            or k.startswith("k3_tpu_group_2_exact")),
         "ms": k3_exact_ms, "plain_ms": k3_exact_plain_ms,
         "bound_ms": k3_bound_exact["ms"], "bound_by": k3_bound_exact["by"],
         "library_ms": None,
         "library_call": "none: no PyTorch call computes an exact wrapping-u64 "
                         "negacyclic product",
         "bound_primes": EXACT_PRIMES,
         "bound_ntt_int32_ms": k3_bound_exact["ntt_ms"],
         "bound_four_step_int8_ms": k3_bound_exact["four_step_ms"],
         "bound_bytes_ms": k3_bound_exact["bytes_ms"],
         "ciphertexts_per_block": kernels.exact_multibit_cts_per_block(
             mp.glwe_dimension + 1, mp.polynomial_size, mp.pbs_level, mp.grouping_factor,
             mp.pbs_base_log),
         "shape": [BATCH, mp.lwe_dimension // mp.grouping_factor,
                   1 << mp.grouping_factor, mp.glwe_dimension + 1, mp.polynomial_size]},
        {"name": "blind_rotate_decompression", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate.cu",
         "replaces": "tfhe_tpu/ops/pallas_mxu.py:1782",
         "launches": decomp_launches["blind_rotate"],
         "max_abs_err": max(v for k, v in errs.items() if k.startswith("k2_decompression")),
         "ms": k2_dec_ms, "plain_ms": k2_dec_plain_ms,
         "bound_ms": k2_dec_bound["ms"], "bound_by": k2_dec_bound["by"],
         "library_ms": None, "bound_primes": V7_PRIMES,
         "bound_ntt_int32_ms": k2_dec_bound["ntt_ms"],
         "bound_four_step_int8_ms": k2_dec_bound["four_step_ms"],
         "bound_bytes_ms": k2_dec_bound["bytes_ms"],
         "shape": [BATCH, msed.shape[1] - 1, p.glwe_dimension + 1, p.polynomial_size]},
        {"name": "packing_keyswitch", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/packing_keyswitch.cu",
         "replaces": "tfhe_tpu/ops/server.py:537",
         "kernel": "packing_keyswitch_imma_kernel (int8 tensor cores; "
                   "packing_keyswitch_kernel elsewhere)",
         "launches": comp_launches["packing_keyswitch"],
         "tensor_core_launches": comp_launches["packing_keyswitch_imma"],
         "generic_launches": (comp_launches["packing_keyswitch"]
                              - comp_launches["packing_keyswitch_imma"]),
         "max_abs_err": max(v for k, v in errs.items() if k.startswith("k4")),
         "ms": k4_ms, "plain_ms": k4_plain_ms, "generic_kernel_ms": k4_generic_ms,
         "bound_ms": k4_b["ms"], "bound_by": k4_b["by"],
         "library_ms": k4_library_ms, "library_gemm_ms": k4_library_gemm_ms,
         "library_call": "int8 torch._int_mm of each GLWE's digit Toeplitz matrix by "
                         "10 seven-bit limbs of the key, in s32-exact K chunks, with "
                         "building the operands (library_gemm_ms: the GEMMs alone)",
         "bound_primes": K4_PRIMES,
         "bound_limbs_int8_ms": k4_b["limbs_int8_ms"],
         "bound_ntt_int32_ms": k4_b["ntt_int32_ms"], "bound_bytes_ms": k4_b["bytes_ms"],
         "inputs_per_block": k4_inputs,
         f"b{K4_BIG_BATCH}": {"ms": k4_big["ms"],
                              "generic_kernel_ms": k4_big["generic_kernel_ms"],
                              "bound_ms": k4_big["bound"]["ms"],
                              "bound_by": k4_big["bound"]["by"],
                              "bound_bytes_ms": k4_big["bound"]["bytes_ms"],
                              "bound_limbs_int8_ms": k4_big["bound"]["limbs_int8_ms"],
                              "share_of_bound": k4_big["bound"]["ms"] / k4_big["ms"]},
         "shape": [BATCH, comp_in.shape[1] - 1] + list(ckey.pksk.shape[1:])},
        {"name": "blind_rotate128", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate128.cu",
         "replaces": "tfhe_tpu/ops/pallas_ntt.py:1123",
         "launches": (sq_launches["blind_rotate128"] + k5_paths["integer_storage"]
                      + k5_paths["hlapi"]),
         "launches_by_path": {"squash": sq_launches["blind_rotate128"],
                              "integer_storage": k5_paths["integer_storage"],
                              "hlapi": k5_paths["hlapi"]},
         "max_abs_err": max(v for k, v in errs.items() if k.startswith("k5")),
         "ms": k5_ms, "plain_ms": k5_plain_ms, "plain_batch": K5_PLAIN_BATCH,
         "bound_ms": k5_b["ms"], "bound_by": k5_b["by"],
         "library_ms": None,
         "library_call": "none: no PyTorch call computes an exact u128 negacyclic product",
         "bound_primes": K5_PRIMES, "bound_ntt_int32_ms": k5_b["ntt_ms"],
         "bound_four_step_int8_ms": k5_b["four_step_ms"], "bound_bytes_ms": k5_b["bytes_ms"],
         "shape": [BATCH, p.lwe_dimension, sqp.decomp_level_count, k1_sq,
                   sqp.polynomial_size]},
        {"name": "cmux_step", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate.cu",
         "replaces": "tfhe_tpu/ops/pallas_ntt.py:296",
         "kernel": "blind_rotate_exact_lazy_kernel, n_steps = 1",
         "launches": st_launches["cmux_step"],
         "launches_by_path": {"stepwise": st_launches["cmux_step"]},
         "max_abs_err": max(v for k, v in errs.items() if k.startswith("k2_step")),
         "ms": k2_step_ms, "plain_ms": k2_step_plain_ms,
         "plain_rotation_ms": k2_step_plain_rotation_ms,
         "probe_before_hlapi_phases": step_probe_before,
         "probe_after_hlapi_phases": step_probe_after,
         "bound_ms": k2_step_bound["ms"], "bound_by": k2_step_bound["by"],
         "library_ms": None, "bound_primes": EXACT_PRIMES,
         "bound_ntt_int32_ms": k2_step_bound["ntt_ms"],
         "bound_four_step_int8_ms": k2_step_bound["four_step_ms"],
         "bound_bytes_ms": k2_step_bound["bytes_ms"],
         "shape": [BATCH, 1, p.glwe_dimension + 1, p.polynomial_size]},
    ]
    # K6, K1 at the PFPKS shape, K2's CMux entry (phases 27-29); K1's
    # limb-row kernel runs the PFPKS (wopbs, aes) and the cast to big
    # (compact_pke)
    limb_paths = {**s13_launches("keyswitch_limbs", ("wopbs", "aes")),
                  "compact_pke": pke_run["line"]["launches"]["cast_big_b32"]["keyswitch_limbs"]}
    generic_limb_paths = {
        path: generic_keyswitches(runs)
        for path, runs in (("wopbs", {c: s13_launches(c, ("wopbs",))["wopbs"] for c in (
                               "keyswitch", "keyswitch_imma", "keyswitch_limbs")}),
                           ("aes", {c: s13_launches(c, ("aes",))["aes"] for c in (
                               "keyswitch", "keyswitch_imma", "keyswitch_limbs")}),
                           ("compact_pke", pke_run["line"]["launches"]["cast_big_b32"]))}
    if any(generic_limb_paths.values()):
        raise RuntimeError(f"a generic K1 launch on wopbs, aes or the cast to big: "
                           f"{generic_limb_paths}")
    cast_big = cast_figs["big_b32"]
    table += [
        {"name": "packing_keyswitch128", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/packing_keyswitch128.cu",
         "replaces": "tfhe_tpu/shortint/noise_squashing.py:299",
         "kernel": "packing_keyswitch128_imma_kernel (int8 tensor cores: 8 digit byte limbs "
                   "x 16 key byte limbs, the pairs below 2^128), then _reduce_kernel",
         "launches": sum(s13_launches("packing_keyswitch128").values()),
         "launches_by_path": {"squash_compress": s13_launches("packing_keyswitch128")[
             "squash_compress"]},
         "max_abs_err": max(v for k, v in errs.items() if k.startswith("k6")),
         "words_differing": {k: v for k, v in errs.items() if k.startswith("k6")},
         "ms": s13["k6"]["ms"], "plain_ms": s13["k6"]["plain_ms"],
         "one_list_ms": s13["k6"]["one_list_ms"],
         "bound_ms": s13["k6"]["bound"]["ms"], "bound_by": s13["k6"]["bound"]["by"],
         "bound_bytes_ms": s13["k6"]["bound"]["bytes_ms"],
         "one_list_bound_ms": s13["k6"]["one_list_bound"]["ms"],
         "multiply_adds": s13["k6"]["bound"]["multiply_adds"],
         "library_ms": None,
         "library_call": "none: torch has no u128 or exact negacyclic product",
         "plain": "tfhe_tpu's formula on the torch half of the 8-prime CRT-NTT",
         "shape": s13["k6"]["shape"]},
        {"name": "keyswitch_pfpks", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/keyswitch.cu",
         "replaces": "tfhe_tpu/shortint/wopbs.py:108",
         "also_replaces": "tfhe_tpu/ops/server.py:84 (the compact list's cast to big)",
         "kernel": (f"keyswitch_limbs_kernel after keyswitch_limb_rows_kernel "
                    f"({wop_l['pfpks_kernel']}: 20-bit digits as "
                    f"{s13['pfpks']['limbs_a_digit']} balanced byte limbs on rows, int8 tensor "
                    f"cores, (k+1)^2 N output columns, row n negated)"),
         "launches": sum(limb_paths.values()), "launches_by_path": limb_paths,
         "generic_launches_by_path": generic_limb_paths,
         "max_abs_err": max(v for k, v in errs.items()
                            if k.startswith(("pfpks_k1", "k1_cast_big"))),
         "words_differing": {k: v for k, v in errs.items()
                             if k.startswith(("pfpks_k1", "k1_cast_big"))},
         **{k: s13["pfpks"][k] for k in LIMB_TIMES},
         "splits": s13["pfpks"]["splits"],
         "plain_ms": s13["pfpks"]["plain_ms"],
         "bound_ms": s13["pfpks"]["bound"]["ms"], "bound_by": s13["pfpks"]["bound"]["by"],
         "bound_bytes_ms": s13["pfpks"]["bound"]["bytes_ms"],
         "library_ms": s13["pfpks"]["library_ms"], "library_call": s13["pfpks"]["library_call"],
         "library_words_differing": s13["pfpks"]["library_words_differing"],
         "shape": s13["pfpks"]["shape"],
         "cast_big": {k: cast_big[k] for k in LIMB_TIMES + (
             "splits", "plain_ms", "library_ms", "library_call", "library_words_differing",
             "bound_ms", "bound_by", "share_of_bound", "limbs_a_digit", "shape")},
         **ptxas_of(ptxas_kernels, "keyswitch_limbs_kernel"),
         "limb_rows_kernel": ptxas_of(ptxas_kernels, "keyswitch_limb_rows_kernel"),
         "generic_kernel": ptxas_of(ptxas_kernels, "keyswitch_kernel")},
        {"name": "cmux", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate_cluster.cu",
         "replaces": "tfhe_tpu/shortint/wopbs.py:212",
         "kernel": "blind_rotate_cluster_small_kernel (route small: N = 512) and "
                   "blind_rotate_cluster_kernel (route cluster: N = 2048, 3 <= k+1 <= 8) in "
                   "their one-step CMux mode; cmux_kernel of csrc/blind_rotate.cu elsewhere "
                   "(route generic)",
         "launches": sum(cmux_paths.values()),
         "launches_by_path": {k: v for k, v in cmux_paths.items() if v},
         "launches_by_route": cmux_routes, "cmux_route": s13["cmux"]["b1"]["route"],
         "max_abs_err": max(v for k, v in errs.items() if k.startswith(("cmux_b", "cm_cmux"))),
         **{k: s13["cmux"]["b1"][k] for k in CMUX_FIGURES},
         "bound_ms": s13["cmux"]["b1"]["bound"]["ms"],
         "bound_by": s13["cmux"]["b1"]["bound"]["by"],
         "library_ms": None,
         "library_call": "none: no PyTorch call computes an exact wrapping-u64 "
                         "negacyclic product",
         "b64": {**{k: s13["cmux"]["b64"][k] for k in CMUX_FIGURES},
                 "cmux_route": s13["cmux"]["b64"]["route"],
                 "bound_ms": s13["cmux"]["b64"]["bound"]["ms"],
                 "bound_by": s13["cmux"]["b64"]["bound"]["by"]},
         "cm": {f"c{c}": {**{k: v for k, v in rp_cmux[c].items()
                             if k not in ("bound", "external_product")},
                          "bound_ms": rp_cmux[c]["bound"]["ms"],
                          "bound_by": rp_cmux[c]["bound"]["by"],
                          "share_of_bound": rp_cmux[c]["bound"]["ms"] / rp_cmux[c]["ms"]}
                for c in CM_CMUX_SLOTS},
         "cm_external_product_c3": {
             "ms": rp_cmux[CM_SLOTS]["external_product"]["ms"],
             "plain_ms": rp_cmux[CM_SLOTS]["external_product"]["plain_ms"],
             "bound_ms": rp_cmux[CM_SLOTS]["external_product"]["bound"]["ms"]},
         "registers": {"small": small_regs(ptxas_kernels, 4, 2, cmux=True),
                       **{f"cluster_k1_{k1}": cluster_regs(ptxas_kernels, k1, 1, 11, cmux=True)
                          for k1 in (4, 5, 8)},
                       "generic": ptxas_of(ptxas_kernels, "cmux_kernel")}}]
    by_name = {entry["name"]: entry for entry in table}
    # the launches of phases 28-30 on K1 (its tensor-core kernel: the
    # integer PBS; the test vectors' keyswitches), K2's exact modes and the
    # step entry
    # (the PFPKS launches of wopbs and aes, K1's generic kernel, are the
    # keyswitch_pfpks row's)
    ks_imma = s13_launches("keyswitch_imma", ("wopbs", "aes", "test_vectors"))
    ks_paths13 = {**ks_imma, "test_vectors": s13_launches("keyswitch")["test_vectors"]}
    by_name["keyswitch"]["launches_by_path"].update(ks_paths13)
    by_name["keyswitch"]["tensor_core_launches_by_path"].update(ks_imma)
    by_name["keyswitch"]["generic_launches_by_path"]["test_vectors"] = (
        ks_paths13["test_vectors"] - ks_imma["test_vectors"]
        - s13_launches("keyswitch_limbs")["test_vectors"])
    by_name["keyswitch"]["launches"] += sum(ks_paths13.values())
    lazy_tv = s13_launches("blind_rotate_exact_lazy")["test_vectors"]
    by_name["blind_rotate_exact"].setdefault("generic_launches_by_path", {}).update(
        {p_: s13_launches("blind_rotate")[p_] - s13_launches("blind_rotate_exact_lazy")[p_]
         - s13_launches("blind_rotate_cluster")[p_] for p_ in ("wopbs", "aes", "test_vectors")})
    by_name["blind_rotate_exact"]["launches_by_path"]["test_vectors"] = lazy_tv
    by_name["blind_rotate_exact"]["launches"] += lazy_tv
    by_name["cmux_step"]["generic_launches_by_path"] = {
        p_: v for p_, v in s13_launches("cmux_step").items() if v}
    # their times at the TEST shapes, launch by launch as phases 28-29 ran
    # them (the route's kernel beside the generic kernel, the first design):
    # the rotation on the small-N cluster kernel; the step entry's low bits
    # now K2's CMux chain, with one step-entry launch at B = 1 timed beside
    by_name["blind_rotate_exact"]["test_shapes"] = s16["rotation"]
    by_name["cmux_step"]["test_shapes"] = {
        "chain": s16["chain"], "step_entry": s16["step_entry"],
        **{f"step_entry_b1_ms_at_chain_b{b}": s17["chain"][f"b{b}"]["step_entry_b1_ms"]
           for b in SMALL_CHAIN_BATCHES},
        **{f"step_entry_b1_host_ms_at_chain_b{b}":
           s17["chain"][f"b{b}"]["step_entry_b1_host_ms"] for b in SMALL_CHAIN_BATCHES}}
    # K2's small-N cluster kernel (the TEST rotation) and its CMux chain
    # (phases 28-29 and the other TEST-set paths)
    small_l1 = small_regs(ptxas_kernels, 1)
    small_l4 = small_regs(ptxas_kernels, 4)
    rot4 = s17["rotation"][f"b{SMALL_ROTATION_BATCHES[0]}"]
    chain1 = s17["chain"][f"b{SMALL_CHAIN_BATCHES[0]}"]
    small_paths = {p_: v for p_, v in s13_launches("blind_rotate_cluster").items() if v}
    table += [
        {"name": "blind_rotate_cluster_small", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate_cluster.cu",
         "replaces": "tfhe_tpu/ops/pallas_ntt.py:794",
         "kernel": "blind_rotate_cluster_small_kernel (K2's exact rotation at the TEST "
                   "shapes, k+1 = 2, N = 512, l <= 4: a cluster of 4 blocks of 128 threads "
                   "a ciphertext, one a CRT prime)",
         "launches": sum(small_paths.values()), "launches_by_path": small_paths,
         "max_abs_err": max(v for k, v in errs.items()
                            if k.startswith(("k2_small", "k2_test_shape_blind_rotate"))),
         "ms": rot4["ms"], "host_ms": rot4["host_ms"], "generic_kernel_ms": rot4["generic_ms"],
         "plain_ms": rot4["plain_ms"], "bound_ms": rot4["bound_ms"],
         "bound_by": rot4["bound_by"], "library_ms": None,
         "library_call": "none: no PyTorch call computes an exact wrapping-u64 negacyclic "
                         "product",
         "by_batch": s17["rotation"], "bound_primes": EXACT_PRIMES,
         **kernels.cluster_figures(2, 512, SMALL_ROTATION[1]),
         "registers": small_l1.get("registers"),
         "spill_store_bytes": small_l1.get("spill_store_bytes"),
         "shape": rot4["shape"]},
        {"name": "cmux_chain", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate_cluster.cu",
         "replaces": "tfhe_tpu/ops/pallas_ntt.py:296",
         "kernel": "blind_rotate_cluster_small_kernel with a key a ciphertext (every "
                   "low bit of a call's vertical packings in one launch, a GGSW set a "
                   "ciphertext)",
         "launches": sum(s13_launches("cmux_chain").values()),
         "launches_by_path": {k: v for k, v in s13_launches("cmux_chain").items() if v},
         "max_abs_err": max(v for k, v in errs.items()
                            if k.startswith(("cmux_chain", "k2_test_shape_cmux_chain"))),
         "ms": chain1["ms"], "host_ms": chain1["host_ms"],
         "generic_kernel_ms": chain1["generic_ms"],
         "step_entry_b1_ms": chain1["step_entry_b1_ms"],
         "step_entry_b1_host_ms": chain1["step_entry_b1_host_ms"],
         "plain_ms": chain1["plain_ms"], "bound_ms": chain1["bound_ms"],
         "bound_by": chain1["bound_by"], "library_ms": None,
         "library_call": "none: no PyTorch call computes an exact wrapping-u64 negacyclic "
                         "product",
         "by_batch": s17["chain"], "bound_primes": EXACT_PRIMES,
         **kernels.cluster_figures(2, 512, SMALL_CHAIN[1]),
         "registers": small_l4.get("registers"),
         "spill_store_bytes": small_l4.get("spill_store_bytes"),
         "shape": chain1["shape"]}]
    # K1-32, and the launches of phases 25-26 on the other kernels' entries
    atomic_table_entries(table, atomic_run, wire_run, errs, k132, ptxas_kernels)
    # K2's cluster kernel (phase 31), and the launches of phases 31-32 on
    # K1, K2's generic exact kernel and K3
    s33_l, ps_l = s33_run["line"], ps_run["line"]
    s14_runs = {"serve_3_3": s33_l["launches"],
                **{f"serve_3_3_radix_{k}": s33_l["radix"][k]["launches"] for k in ("add", "mul")},
                **{f"param_sets_{t}{suffix}": ps_l[t][key] for t, *_ in PARAM_SETS
                   for suffix, key in PARAM_SETS_RUNS}}

    def s14_by_path(counter: str, paths=None) -> dict:
        """Launches of one counter on each path of phases 31-32 whose name
        starts with one of paths (all where None)."""
        return {path: c.get(counter, 0) for path, c in s14_runs.items()
                if c.get(counter, 0) and (paths is None or path.startswith(paths))}

    # its 3_3 instance (k+1 = 2, l = 2, log N = 13)
    cl_regs = cluster_regs(ptxas_kernels, 2, 2, 13)
    table.append({
        "name": "blind_rotate_cluster", "route": "cuda",
        "source": "tfhe_tpu_torch/csrc/blind_rotate_cluster.cu",
        "replaces": "tfhe_tpu/ops/pallas_ntt.py:794",
        "kernel": "blind_rotate_cluster_kernel (K2's exact rotation, a cluster of 4 blocks a "
                  "ciphertext, one a CRT prime: 3_3, k+1 = 2, l = 2, N = 8192)",
        "launches": sum(s14_by_path("blind_rotate_cluster", ("serve_3_3",)).values()),
        "launches_by_path": s14_by_path("blind_rotate_cluster", ("serve_3_3",)),
        "max_abs_err": max(v for k, v in errs.items() if k.startswith("k2_cluster")),
        "words_differing": {k: v for k, v in errs.items() if k.startswith("k2_cluster")},
        "ms": s14["ms"], "b4_ms": s14["b4_ms"], "plain_ms": s14["plain_b4_ms"],
        "plain_batch": CHECK_BATCH,
        "bound_ms": s14["bound"]["ms"], "bound_by": s14["bound"]["by"],
        "b4_bound_ms": s14["b4_bound"]["ms"], "bound_primes": EXACT_PRIMES,
        "bound_ntt_int32_ms": s14["bound"]["ntt_ms"],
        "bound_four_step_int8_ms": s14["bound"]["four_step_ms"],
        "bound_bytes_ms": s14["bound"]["bytes_ms"],
        "library_ms": None,
        "library_call": "none: no PyTorch call computes an exact wrapping-u64 negacyclic "
                        "product",
        "shared_memory_bytes": s14["shared_memory_bytes"],
        "one_block_would_need_bytes": s14["generic_kernel_bytes"],
        "registers": cl_regs.get("registers"), "spill_store_bytes": cl_regs.get(
            "spill_store_bytes"),
        "shape": s14["shape"]})
    # phase 32's new routes: K2's small-N kernel at 1_1 (k+1 = 5) and K3's
    # cluster kernel at the GPU GROUP_2 and GROUP_3 sets
    table += param_sets_table_entries(s18, s14_by_path, errs, ptxas_kernels)
    # K7, K8, and K2 and K1 at phase 33's shapes
    table += research_table_entries(kernels, rp_run, s15, errs, ptxas_kernels, p)
    # K9, phase 37's poly-sharded PBS and latency route: the step entries on
    # the key's preparation and the sharded product, the fused entry on
    # every poly-sharded rotation of one card
    step_entries = ("forward", "cross", "inverse")
    k9_by_path = {f"multi_device_prepare_key_d{d}": sum(v[f"poly_shard_{e}"] for e in step_entries)
                  for d, v in md_run["prep_runs"].items()}
    k9_by_path["multi_device_sharded_polymul"] = sum(
        md_run["polymul_launches"][f"poly_shard_{e}"] for e in step_entries)
    k9_by_path["multi_device_poly_steps_route_d{}_b{}".format(*K9_STEPS_ROUTE)] = sum(
        md_run["steps_route_launches"].values())
    k9_main = s21[f"d{K9_MAIN[0]}_b{K9_MAIN[1]}"]
    table.append({
        "name": "poly_shard", "route": "cuda", "source": "tfhe_tpu_torch/csrc/poly_shard.cu",
        "replaces": "tfhe_tpu/parallel/poly_shard.py:118",
        "also_replaces": ["tfhe_tpu/parallel/poly_shard.py:107",
                          "tfhe_tpu/parallel/poly_shard.py:137"],
        "replaces_kind": "XLA mod-p matmul stages of a shard_map program, not a pallas_call",
        "kernel": "ps_forward_kernel, ps_cross_kernel, ps_inverse_kernel (K9's step entries: "
                  "the slot-local stages of the four-step split, three launches a CMux step a "
                  "slot on a mesh of distinct cards, forced once on the one-card mesh; the key's "
                  "preparation, the sharded product)",
        "launches": sum(k9_by_path.values()), "launches_by_path": k9_by_path,
        "max_abs_err": max(v for k, v in errs.items()
                           if k.startswith("k9") and not k.startswith("k9_rotate")),
        "words_differing": {k: v for k, v in errs.items()
                            if k.startswith("k9") and not k.startswith("k9_rotate")},
        "ms": k9_main["step_ms"], "plain_ms": k9_main["step_plain_ms"],
        "ms_is": "one CMux step: entries a, b and c on every slot, D = 4, B = 4, from "
                 "CUDA graphs (the exchanges between them not counted)",
        "events_ms": k9_main["step_events_ms"], "host_ms": k9_main["step_host_ms"],
        "bound_ms": k9_main["bound"]["ms"], "bound_by": k9_main["bound"]["by"],
        "bound_bytes_ms": k9_main["bound"]["bytes_ms"],
        "bound_ops_int32_ms": k9_main["bound"]["ops_ms"],
        "library_ms": None, "library_call": "none (no int64 matmul on CUDA)",
        "by_shape": s21,
        "registers": {k: ptxas_of(ptxas_kernels, k).get("registers")
                      for k in ("ps_forward_kernel", "ps_cross_kernel", "ps_inverse_kernel")},
        "spill_store_bytes": {k: ptxas_of(ptxas_kernels, k).get("spill_store_bytes")
                              for k in ("ps_forward_kernel", "ps_cross_kernel",
                                        "ps_inverse_kernel")}})
    rot_by_path = {f"multi_device_poly_d{d}_b{b}": runs["poly_shard_rotate"]
                   for (d, b), runs in md_run["poly_runs"].items()}
    rot_by_path["multi_device_latency_fheuint8_add"] = (
        md_run["line"]["latency_fheuint8_add"]["launches"]["poly_shard_rotate"])
    rot_d, rot_b = K9_ROTATE_MAIN
    rot_main = md_run["line"]["poly"][f"d{rot_d}_b{rot_b}"]
    rot_bound = k9_rotate_bound(rot_d, rot_b, p.glwe_dimension + 1, p.polynomial_size,
                                p.pbs_level, p.lwe_dimension)
    rot_plain = s22[f"d{rot_d}_b{rot_b}_k1_{p.glwe_dimension + 1}_l{p.pbs_level}"]
    rot_regs = ptxas_of(ptxas_kernels, "ps_rotate_kernel")
    table.append({
        "name": "poly_shard_rotate", "route": "cuda", "source": "tfhe_tpu_torch/csrc/poly_shard.cu",
        "replaces": "tfhe_tpu/parallel/poly_shard.py:285",
        "also_replaces": ["tfhe_tpu/parallel/poly_shard.py:108",
                          "tfhe_tpu/parallel/poly_shard.py:118",
                          "tfhe_tpu/parallel/poly_shard.py:137"],
        "replaces_kind": "sharded_blind_rotate_poly's scan over XLA mod-p matmul stages of a "
                         "shard_map program, not a pallas_call",
        "kernel": "ps_rotate_kernel (K9's fused entry: all n CMux steps in one launch, one "
                  "thread-block cluster a ciphertext, one block a (slot, prime), the exchanges "
                  "through distributed shared memory)",
        "launches": sum(rot_by_path.values()), "launches_by_path": rot_by_path,
        "max_abs_err": max(v for k, v in errs.items() if k.startswith("k9_rotate")),
        "words_differing": {k: v for k, v in errs.items() if k.startswith("k9_rotate")},
        "ms": rot_main["rotate_ms"], "us_a_step": rot_main["rotate_us_a_step"],
        "ms_is": f"one rotation of phase 3's key (n = {p.lwe_dimension}) at D = {rot_d}, "
                 f"B = {rot_b} on the call's switched inputs, CUDA events over 3 launches",
        "plain_ms": rot_plain["plain_ms"] * p.lwe_dimension / K9_ROTATE_STEPS,
        "plain_ms_is": f"the plain step loop on the card over {K9_ROTATE_STEPS} steps of a random "
                       f"key, scaled to n = {p.lwe_dimension}",
        "bound_ms": rot_bound["ms"], "bound_by": rot_bound["by"],
        "bound_bytes_ms": rot_bound["bytes_ms"], "bound_ops_int32_ms": rot_bound["ops_ms"],
        "bound_steps_ms": rot_bound["steps_bound_ms"],
        "library_ms": None, "library_call": "none (no int64 matmul on CUDA)",
        "poly_pbs_seconds": {k: v["seconds_a_pbs"] for k, v in md_run["line"]["poly"].items()},
        "k2_exact_seconds": {k: v["seconds"] for k, v in md_run["line"]["k2_exact"].items()},
        "by_shape": s22, "plan": rot_main["plan"],
        "active_clusters": rot_plain["active_clusters"],
        "registers": rot_regs.get("registers"),
        "spill_store_bytes": rot_regs.get("spill_store_bytes")})
    by_name = {entry["name"]: entry for entry in table}
    for name, counter, paths, key in (
            ("keyswitch", "keyswitch", None, "launches_by_path"),
            ("keyswitch", "keyswitch_imma", None, "tensor_core_launches_by_path"),
            ("blind_rotate_multibit", "blind_rotate_multibit", ("param_sets_gpu_group_4_1_1",),
             "launches_by_path")):
        extra = s14_by_path(counter, paths)
        by_name[name].setdefault(key, {}).update(extra)
        if key == "launches_by_path":
            by_name[name]["launches"] += sum(extra.values())
    k6_entry = by_name["packing_keyswitch128"]
    k6_entry.update({k: s13["k6"][k] for k in (
        "ms_again", "shared_memory_bytes", "key_limbs_device_bytes")})
    k6_entry["bound_ops_int32_ms"] = s13["k6"]["bound"]["ops_int32_ms"]
    k6_entry["bound_ops_limbs_int8_ms"] = s13["k6"]["bound"]["ops_limbs_int8_ms"]
    # its V1_4 instance (k+1 = 7)
    k6_regs = next((v for k, v in ptxas_kernels.items()
                    if "packing_keyswitch128_imma_kernelILi7E" in k), {})
    k6_entry["registers"] = k6_regs.get("registers")
    k6_entry["spill_store_bytes"] = k6_regs.get("spill_store_bytes")
    # the rounded-key routes: primes and ciphertexts a block
    for name, key in (("blind_rotate", sk.bsk_ntt), ("blind_rotate_multibit", msk.bsk_ntt),
                      ("blind_rotate_decompression", dk.bsk_ntt)):
        entry = by_name[name]
        entry["primes"] = key.num_primes
        entry.update(kernels.rounded_kernel_shape(key.num_primes))
    for entry in table:
        entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
