"""BLS12-446 pairing curve (pure Python bigints).

Re-implementation of tfhe-zk-pok's curve layer (tfhe-zk-pok/src/curve_446/
mod.rs — parameters only; the arithmetic here is standard textbook
Miller-loop optimal-ate pairing, written fresh):
  - Fq: 446-bit base field, Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3-(u+1)),
    Fq12 = Fq6[w]/(w^2-v)
  - G1: y^2 = x^3 + 1 over Fq;  G2: y^2 = x^3 + (u+1) over Fq2 (M twist)
  - BLS parameter x = -0x6008204000000020001
  - optimal ate pairing with BLS final exponentiation
  - Pippenger MSM (the CPU analog of backends/zk-cuda-backend's GPU MSM)

Port of tfhe_tpu/zk/curve446.py, the same points from the same inputs.
This is host crypto: it stays on the CPU (the reference likewise keeps ZK
on the CPU unless its CUDA MSM backend is enabled).  Scalar multiplication,
the MSM, the power chains and the pairings run in csrc/bls446.cpp, built
with g++ at first use (``native()``; a failed build or load raises).  The
pure-Python versions (``*_plain``) are what the tests hold the native ones
against.
"""

from __future__ import annotations

# field / curve constants (curve_446/mod.rs)
P = 172824703542857155980071276579495962243492693522789898437834836356385656662277472896902502740297183690175962001546428467344062165330603
R = 645383785691237230677916041525710377746967055506026847120930304831624105190538527824412673
X_ABS = 0x6008204000000020001
X_IS_NEGATIVE = True

G1_GEN = (
    143189966182216199425404656824735381247272236095050141599848381692039676741476615087722874458136990266833440576646963466074693171606778,
    75202396197342917254523279069469674666303680671605970245803554133573745859131002231546341942288521574682619325841484506619191207488304,
)
G2_GEN = (
    (96453755443802578867745476081903764610578492683850270111202389209355548711427786327510993588141991264564812146530214503491136289085725,
     85346509177292795277012009839788781950274202400882571466460158277083221521663169974265433098009350061415973662678938824527658049065530),
    (49316184343270950587272132771103279293158283984999436491292404103501221698714795975575879957605051223501287444864258801515822358837529,
     107680854723992552431070996218129928499826544031468382031848626814251381379173928074140221537929995580031433096217223703806029068859074),
)


def fq_inv(a: int) -> int:
    return pow(a, P - 2, P)


# ---------------------------------------------------------------------------
# Fq2 = Fq[u] / (u^2 + 1): elements (a, b) = a + b*u
# ---------------------------------------------------------------------------


def f2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def f2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def f2_neg(x):
    return ((-x[0]) % P, (-x[1]) % P)


def f2_mul(x, y):
    a, b = x
    c, d = y
    ac = a * c
    bd = b * d
    return ((ac - bd) % P, ((a + b) * (c + d) - ac - bd) % P)


def f2_sq(x):
    a, b = x
    return ((a + b) * (a - b) % P, 2 * a * b % P)


def f2_muls(x, s: int):
    return (x[0] * s % P, x[1] * s % P)


def f2_inv(x):
    a, b = x
    t = fq_inv((a * a + b * b) % P)
    return (a * t % P, (-b * t) % P)


def f2_conj(x):
    return (x[0], (-x[1]) % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (1, 1)  # the sextic nonresidue u + 1


def f2_mul_xi(x):
    """(a+bu)(1+u) = (a-b) + (a+b)u."""
    a, b = x
    return ((a - b) % P, (a + b) % P)


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v] / (v^3 - XI): elements (c0, c1, c2)
# ---------------------------------------------------------------------------


def f6_add(x, y):
    return tuple(f2_add(a, b) for a, b in zip(x, y))


def f6_sub(x, y):
    return tuple(f2_sub(a, b) for a, b in zip(x, y))


def f6_neg(x):
    return tuple(f2_neg(a) for a in x)


def f6_mul(x, y):
    a0, a1, a2 = x
    b0, b1, b2 = y
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_sq(x):
    return f6_mul(x, x)


def f6_mul_v(x):
    """x * v: (c0,c1,c2) -> (xi*c2, c0, c1)."""
    return (f2_mul_xi(x[2]), x[0], x[1])


def f6_inv(x):
    a0, a1, a2 = x
    c0 = f2_sub(f2_sq(a0), f2_mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_xi(f2_sq(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sq(a1), f2_mul(a0, a2))
    t = f2_inv(f2_add(f2_mul(a0, c0),
                      f2_add(f2_mul_xi(f2_mul(a2, c1)), f2_mul_xi(f2_mul(a1, c2)))))
    return (f2_mul(c0, t), f2_mul(c1, t), f2_mul(c2, t))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w] / (w^2 - v): elements (c0, c1)
# ---------------------------------------------------------------------------


def f12_mul(x, y):
    a0, a1 = x
    b0, b1 = y
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_v(t1))
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (c0, c1)


def f12_sq(x):
    a0, a1 = x
    t = f6_mul(a0, a1)
    c0 = f6_add(f6_mul(f6_add(a0, a1), f6_add(a0, f6_mul_v(a1))), f6_neg(f6_add(t, f6_mul_v(t))))
    return (c0, f6_add(t, t))


def f12_inv(x):
    a0, a1 = x
    t = f6_inv(f6_sub(f6_sq(a0), f6_mul_v(f6_sq(a1))))
    return (f6_mul(a0, t), f6_neg(f6_mul(a1, t)))


def f12_conj(x):
    return (x[0], f6_neg(x[1]))


F12_ONE = (F6_ONE, F6_ZERO)


def f12_pow(x, e: int):
    if e < 0:
        x = f12_inv(x)
        e = -e
    out = F12_ONE
    for bit in bin(e)[2:]:
        out = f12_sq(out)
        if bit == "1":
            out = f12_mul(out, x)
    return out


# Frobenius coefficients: gamma_1[i] = XI^((p-1)*i/6) in Fq2
def _frob_coeffs():
    e = (P - 1) // 6
    base_a, base_b = XI
    # XI^e in Fq2 via square-and-multiply
    def f2_pow(x, n):
        out = F2_ONE
        for bit in bin(n)[2:]:
            out = f2_sq(out)
            if bit == "1":
                out = f2_mul(out, x)
        return out

    g = [f2_pow(XI, e * i) for i in range(6)]
    return g


_GAMMA = _frob_coeffs()


def f12_frobenius(x):
    """x -> x^p."""
    c0, c1 = x
    # conjugate each Fq2 coefficient, multiply by gamma powers
    n0 = (f2_conj(c0[0]),
          f2_mul(f2_conj(c0[1]), _GAMMA[2]),
          f2_mul(f2_conj(c0[2]), _GAMMA[4]))
    n1 = (f2_mul(f2_conj(c1[0]), _GAMMA[1]),
          f2_mul(f2_conj(c1[1]), _GAMMA[3]),
          f2_mul(f2_conj(c1[2]), _GAMMA[5]))
    return (n0, n1)


# ---------------------------------------------------------------------------
# G1 / G2 points: affine tuples (x, y) or None for infinity
# ---------------------------------------------------------------------------


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 1) % P == 0


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * fq_inv(2 * y1) % P
    else:
        lam = (y2 - y1) * fq_inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g1_neg(p1):
    return None if p1 is None else (p1[0], (-p1[1]) % P)


# Jacobian coordinates for inversion-free scalar mults / MSM interiors:
# (X, Y, Z) with x = X/Z^2, y = Y/Z^3; None = infinity.


def _j_from_affine(pt):
    return None if pt is None else (pt[0], pt[1], 1)


def _j_to_affine(pt):
    if pt is None:
        return None
    x, y, z = pt
    zi = fq_inv(z)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def _j_dbl(pt):
    if pt is None:
        return None
    x, y, z = pt
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) - a - c) % P
    e = 3 * a % P
    f = e * e % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3)


def _j_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        if s1 != s2:
            return None
        return _j_dbl(p1)
    h = (u2 - u1) % P
    i = (2 * h) * (2 * h) % P
    j = h * i % P
    rr = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (rr * rr - j - 2 * v) % P
    y3 = (rr * (v - x3) - 2 * s1 * j) % P
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) % P * h % P
    return (x3, y3, z3)


def g1_mul(p1, k: int):
    import ctypes

    out = ctypes.create_string_buffer(112)
    native().bls446_g1_mul(_pt1_pack(p1), _sc_pack(k % R), out)
    return _pt1_unpack(out.raw)


def g1_mul_plain(p1, k: int):
    k %= R
    out = None
    add = _j_from_affine(p1)
    while k:
        if k & 1:
            out = _j_add(out, add)
        add = _j_dbl(add)
        k >>= 1
    return _j_to_affine(out)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return f2_sub(f2_sq(y), f2_add(f2_mul(f2_sq(x), x), XI)) == F2_ZERO


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_muls(f2_sq(x1), 3), f2_inv(f2_muls(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sq(lam), f2_add(x1, x2))
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def g2_neg(p1):
    return None if p1 is None else (p1[0], f2_neg(p1[1]))


def _j2_dbl(pt):
    if pt is None:
        return None
    x, y, z = pt
    a = f2_sq(x)
    b = f2_sq(y)
    c = f2_sq(b)
    d = f2_muls(f2_sub(f2_sq(f2_add(x, b)), f2_add(a, c)), 2)
    e = f2_muls(a, 3)
    f = f2_sq(e)
    x3 = f2_sub(f, f2_muls(d, 2))
    y3 = f2_sub(f2_mul(e, f2_sub(d, x3)), f2_muls(c, 8))
    z3 = f2_muls(f2_mul(y, z), 2)
    return (x3, y3, z3)


def _j2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1 = f2_sq(z1)
    z2z2 = f2_sq(z2)
    u1 = f2_mul(x1, z2z2)
    u2 = f2_mul(x2, z1z1)
    s1 = f2_mul(f2_mul(y1, z2), z2z2)
    s2 = f2_mul(f2_mul(y2, z1), z1z1)
    if u1 == u2:
        if s1 != s2:
            return None
        return _j2_dbl(p1)
    h = f2_sub(u2, u1)
    i = f2_sq(f2_muls(h, 2))
    j = f2_mul(h, i)
    rr = f2_muls(f2_sub(s2, s1), 2)
    v = f2_mul(u1, i)
    x3 = f2_sub(f2_sub(f2_sq(rr), j), f2_muls(v, 2))
    y3 = f2_sub(f2_mul(rr, f2_sub(v, x3)), f2_muls(f2_mul(s1, j), 2))
    z3 = f2_mul(f2_sub(f2_sq(f2_add(z1, z2)), f2_add(z1z1, z2z2)), h)
    return (x3, y3, z3)


def _j2_to_affine(pt):
    if pt is None:
        return None
    x, y, z = pt
    zi = f2_inv(z)
    zi2 = f2_sq(zi)
    return (f2_mul(x, zi2), f2_mul(f2_mul(y, zi2), zi))


def g2_mul(p1, k: int):
    import ctypes

    out = ctypes.create_string_buffer(224)
    native().bls446_g2_mul(_pt2_pack(p1), _sc_pack(k % R), out)
    return _pt2_unpack(out.raw)


def g2_mul_plain(p1, k: int):
    k %= R
    out = None
    add = None if p1 is None else (p1[0], p1[1], F2_ONE)
    while k:
        if k & 1:
            out = _j2_add(out, add)
        add = _j2_dbl(add)
        k >>= 1
    return _j2_to_affine(out)


# ---------------------------------------------------------------------------
# Optimal ate pairing (M-type twist: lines land in c1 of Fq12 via w-coeffs)
# ---------------------------------------------------------------------------


def _line_eval(q1, q2, p):
    """Line through q1, q2 (G2 points), evaluated at p in G1, as a sparse
    Fq12 element.  For the M twist the line is c0 + c1*w + c2*w^3 with
    Fq2 coefficients; we build the full Fq12 element directly."""
    xp, yp = p
    x1, y1 = q1
    x2, y2 = q2
    if x1 == x2 and y1 == y2:
        lam_num = f2_muls(f2_sq(x1), 3)
        lam_den = f2_muls(y1, 2)
    elif x1 == x2:
        # vertical line on the twist: xp*w^2 - x1
        return ((f2_neg(x1), f2_muls(F2_ONE, xp), F2_ZERO), F6_ZERO)
    else:
        lam_num = f2_sub(y2, y1)
        lam_den = f2_sub(x2, x1)
    # Pairing computed on the M twist: P maps into E'(Fq12) via
    # (xp, yp) -> (xp*w^2, yp*w^3) (w^6 = xi), and the twist line through
    # (x1, y1), (x2, y2), scaled by lam_den, evaluates to
    #   l = (lam_num*x1 - lam_den*y1)        * w^0
    #     + (-lam_num*xp)                    * w^2
    #     + (lam_den*yp)                     * w^3
    a = f2_sub(f2_mul(lam_num, x1), f2_mul(lam_den, y1))  # w^0
    b = f2_neg(f2_muls(lam_num, xp))                      # w^2
    c = f2_muls(lam_den, yp)                              # w^3
    # Fq12 = c0(v) + c1(v)*w with v = w^2:
    #   w^0 -> c0[0], w^2 -> c0[1], w^3 -> c1[1]
    return ((a, b, F2_ZERO), (F2_ZERO, c, F2_ZERO))


def miller_loop(q, p):
    """f_{|x|, Q}(P) with the BLS shortcut; conjugated afterwards for x<0."""
    f = F12_ONE
    t = q
    bits = bin(X_ABS)[3:]
    for bit in bits:
        f = f12_sq(f)
        f = f12_mul(f, _line_eval(t, t, p))
        t = g2_add(t, t)
        if bit == "1":
            f = f12_mul(f, _line_eval(t, q, p))
            t = g2_add(t, q)
    if X_IS_NEGATIVE:
        f = f12_conj(f)
    return f


def final_exponentiation(f):
    """f^((p^12 - 1)/r) via the standard easy + BLS hard part."""
    # easy: f^(p^6-1)(p^2+1)
    f1 = f12_mul(f12_conj(f), f12_inv(f))          # f^(p^6 - 1)
    f2 = f12_mul(f12_frobenius(f12_frobenius(f1)), f1)  # ^(p^2 + 1)
    # hard part (generic, exponent (p^4 - p^2 + 1)/r as an integer —
    # correct for any curve; slower than the x-ladder but simpler)
    e = (P ** 4 - P ** 2 + 1) // R
    return f12_pow(f2, e)


def _f12_unpack(raw: bytes):
    v = [int.from_bytes(raw[56 * i:56 * (i + 1)], "little") for i in range(12)]
    return (((v[0], v[1]), (v[2], v[3]), (v[4], v[5])),
            ((v[6], v[7]), (v[8], v[9]), (v[10], v[11])))


def pairing(p, q):
    """e(P in G1, Q in G2) in Fq12 (unit target group element), in
    csrc/bls446.cpp (full Fp6/Fp12 towers + Miller loop + final
    exponentiation)."""
    if p is None or q is None:
        return F12_ONE
    import ctypes

    out = ctypes.create_string_buffer(672)
    native().bls446_pairing(_pt1_pack(p), _pt2_pack(q), out)
    return _f12_unpack(out.raw)


def pairing_plain(p, q):
    """The pure-Python pairing (the tower above)."""
    if p is None or q is None:
        return F12_ONE
    return final_exponentiation(miller_loop(q, p))


def pairing_product(pairs):
    """prod_i e(P_i, Q_i) with ONE shared final exponentiation (native):
    the shape every verification equation takes once the rhs is moved
    across with negated G1 points."""
    import ctypes

    live = [(p, q) for p, q in pairs if p is not None and q is not None]
    if not live:
        return F12_ONE
    ps = b"".join(_pt1_pack(p) for p, _ in live)
    qs = b"".join(_pt2_pack(q) for _, q in live)
    out = ctypes.create_string_buffer(672)
    native().bls446_pairing_product(ps, qs, len(live), out)
    return _f12_unpack(out.raw)


def pairing_product_plain(pairs):
    acc = F12_ONE
    for p, q in pairs:
        acc = f12_mul(acc, pairing_plain(p, q))
    return acc


# ---------------------------------------------------------------------------
# Native backend (csrc/bls446.cpp): Montgomery-limb Pippenger MSM, fixed-base
# power chains and the pairing, the analog of the reference's hand-rolled
# Rust curve core + zk-cuda-backend GPU MSM.  Built at first use with g++
# for this host's CPU (-march=native), never loaded from another machine.
# ---------------------------------------------------------------------------


class _Native:
    lib = None


def native():
    """The ctypes library of csrc/bls446.cpp, built (first use only) and
    initialised with the field and pairing constants.  Raises if the build
    or the load fails."""
    if _Native.lib is not None:
        return _Native.lib
    import ctypes

    from ..utils.build import CSRC, build_shared_libraries

    (so,) = build_shared_libraries([(
        "tfhe_torch_bls446", [CSRC / "bls446.cpp"],
        ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"])])
    lib = ctypes.CDLL(str(so))
    u64, i64 = ctypes.c_uint64, ctypes.c_int64
    cp, vp = ctypes.c_char_p, ctypes.c_void_p
    lib.bls446_init.argtypes = [cp, cp, u64]
    lib.bls446_g1_msm.argtypes = [cp, cp, u64, vp]
    lib.bls446_g2_msm.argtypes = [cp, cp, u64, vp]
    lib.bls446_g1_powers.argtypes = [cp, cp, u64, i64, vp]
    lib.bls446_g2_powers.argtypes = [cp, cp, u64, i64, vp]
    lib.bls446_g1_mul.argtypes = [cp, cp, vp]
    lib.bls446_g2_mul.argtypes = [cp, cp, vp]
    lib.bls446_pairing_init.argtypes = [cp, cp, u64, cp, u64, ctypes.c_int]
    lib.bls446_pairing.argtypes = [cp, cp, vp]
    lib.bls446_pairing_product.argtypes = [cp, cp, u64, vp]
    for name in ("init", "g1_msm", "g2_msm", "g1_powers", "g2_powers", "g1_mul", "g2_mul",
                 "pairing_init", "pairing", "pairing_product"):
        getattr(lib, f"bls446_{name}").restype = None
    r2 = pow(1 << 448, 2, P)
    n0 = (-pow(P, -1, 1 << 64)) % (1 << 64)
    lib.bls446_init(P.to_bytes(56, "little"), r2.to_bytes(56, "little"), u64(n0))
    gam = b"".join(int(g[0]).to_bytes(56, "little") + int(g[1]).to_bytes(56, "little")
                   for g in _GAMMA[1:6])
    hard = (P ** 4 - P ** 2 + 1) // R
    hard_be = hard.to_bytes((hard.bit_length() + 7) // 8, "big")
    x_be = X_ABS.to_bytes((X_ABS.bit_length() + 7) // 8, "big")
    lib.bls446_pairing_init(gam, hard_be, u64(len(hard_be)), x_be, u64(len(x_be)),
                            1 if X_IS_NEGATIVE else 0)
    _Native.lib = lib
    return lib


def _pt1_pack(p) -> bytes:
    if p is None:
        return b"\x00" * 112
    return int(p[0]).to_bytes(56, "little") + int(p[1]).to_bytes(56, "little")


def _pt1_unpack(b: bytes):
    if b == b"\x00" * 112:
        return None
    return (int.from_bytes(b[:56], "little"),
            int.from_bytes(b[56:], "little"))


def _pt2_pack(p) -> bytes:
    if p is None:
        return b"\x00" * 224
    (x0, x1), (y0, y1) = p
    return b"".join(int(v).to_bytes(56, "little") for v in (x0, x1, y0, y1))


def _pt2_unpack(b: bytes):
    if b == b"\x00" * 224:
        return None
    v = [int.from_bytes(b[56 * i : 56 * (i + 1)], "little") for i in range(4)]
    return ((v[0], v[1]), (v[2], v[3]))


def _sc_pack(s: int) -> bytes:
    return int(s % R).to_bytes(40, "little")


def _powers(name: str, mul, pack, unpack, size: int, base, alpha: int, count: int,
            skip: int) -> list:
    """The native power chain cut into one run a CPU core, in threads (a
    ctypes call releases the GIL): run j starts from alpha^start_j * base,
    so each output is the same point the single chain gives."""
    import ctypes
    import os
    from concurrent.futures import ThreadPoolExecutor

    fn = getattr(native(), name)
    runs = max(1, min(len(os.sched_getaffinity(0)), count // 64))
    step = -(-count // runs) if count else 1

    def run(start: int) -> list:
        n = min(step, count - start)
        first = base if start == 0 else mul(base, pow(alpha, start, R))
        out = ctypes.create_string_buffer(size * n)
        fn(pack(first), _sc_pack(alpha), n, skip - start if start <= skip < start + n else -1,
           out)
        return [unpack(out.raw[size * i : size * (i + 1)]) for i in range(n)]

    with ThreadPoolExecutor(runs) as pool:
        return [pt for part in pool.map(run, range(0, count, step)) for pt in part]


def g1_powers(base, alpha: int, count: int, skip: int = -1) -> list:
    """[alpha^(i+1) * base for i in range(count)] with None at index skip
    (the CRS hot loop: powers-of-alpha g-lists)."""
    return _powers("bls446_g1_powers", g1_mul, _pt1_pack, _pt1_unpack, 112, base, alpha,
                   count, skip)


def g1_powers_plain(base, alpha: int, count: int, skip: int = -1) -> list:
    res, cur = [], alpha % R
    for i in range(count):
        res.append(None if i == skip else g1_mul_plain(base, cur))
        cur = cur * alpha % R
    return res


def g2_powers(base, alpha: int, count: int, skip: int = -1) -> list:
    return _powers("bls446_g2_powers", g2_mul, _pt2_pack, _pt2_unpack, 224, base, alpha,
                   count, skip)


def g2_powers_plain(base, alpha: int, count: int, skip: int = -1) -> list:
    res, cur = [], alpha % R
    for i in range(count):
        res.append(None if i == skip else g2_mul_plain(base, cur))
        cur = cur * alpha % R
    return res


# ---------------------------------------------------------------------------
# Multi-scalar multiplication (Pippenger): native at 4 points or more, as
# tfhe_tpu; the pure-Python Pippenger is the plain version
# ---------------------------------------------------------------------------


def msm_g1(points: list, scalars: list):
    if len(points) >= 4:
        import ctypes

        out = ctypes.create_string_buffer(112)
        native().bls446_g1_msm(b"".join(_pt1_pack(p) for p in points),
                               b"".join(_sc_pack(s) for s in scalars),
                               len(points), out)
        return _pt1_unpack(out.raw)
    return msm_g1_plain(points, scalars)


def msm_g1_plain(points: list, scalars: list):
    jac = [_j_from_affine(p) for p in points]
    return _j_to_affine(_msm(jac, scalars, _j_add, None))


def msm_g2(points: list, scalars: list):
    if len(points) >= 4:
        import ctypes

        out = ctypes.create_string_buffer(224)
        native().bls446_g2_msm(b"".join(_pt2_pack(p) for p in points),
                               b"".join(_sc_pack(s) for s in scalars),
                               len(points), out)
        return _pt2_unpack(out.raw)
    return msm_g2_plain(points, scalars)


def msm_g2_plain(points: list, scalars: list):
    jac = [None if p is None else (p[0], p[1], F2_ONE) for p in points]
    return _j2_to_affine(_msm(jac, scalars, _j2_add, None))


def _msm(points, scalars, add, zero):
    n = len(points)
    if n == 0:
        return zero
    c = max(2, n.bit_length())  # window size
    nbits = R.bit_length()
    windows = []
    for w0 in range(0, nbits, c):
        buckets = [zero] * ((1 << c) - 1)
        for pt, s in zip(points, scalars):
            idx = (int(s) >> w0) & ((1 << c) - 1)
            if idx:
                buckets[idx - 1] = add(buckets[idx - 1], pt)
        acc = zero
        total = zero
        for b in reversed(buckets):
            acc = add(acc, b)
            total = add(total, acc)
        windows.append(total)
    out = zero
    for wv in reversed(windows):
        for _ in range(c):
            out = add(out, out)
        out = add(out, wv)
    return out
