"""Port parity: the digit-GEMM arithmetic of afesp_tpu_torch.ops.exact_gemm
(and the split-f32 GEMM of ops.split_gemm) against the JAX package's on
the CPU, on inputs made with numpy from seeds.

The contract is exactness: the scales and digits are equal, and on every
flat-scale route (direct, pre-digitized, prechunked on either side or
both, the int8 recombination) the product is equal bit for bit.  The
port's two ways of computing a digit-pair product (`route` "int8",
torch._int_mm, and "f32", chunked f32 matmul) give the same bits.  The
per-chunk-scaled operand and its streamed GEMM hold a stated tolerance:
their cross-chunk reduction rounds in f64, in an order XLA chooses."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afesp_tpu.methods import ccsd_spatial as jsp
from afesp_tpu.methods import ccsd_spinorb as jso
from afesp_tpu.ops import exact_gemm as J
from afesp_tpu.ops import split_gemm as jsplit
from afesp_tpu_torch.methods import ccsd_spatial as tsp
from afesp_tpu_torch.methods import ccsd_spinorb as tso
from afesp_tpu_torch.ops import exact_gemm as T
from afesp_tpu_torch.ops import split_gemm as tsplit


def _t(x):
    return torch.tensor(np.asarray(x))


def _data(kind: str, shape, seed: int) -> np.ndarray:
    """Normal data, or adversarial: exact zeros, 1e-300 and 1e300
    entries, mixed signs and ~80 decades of range across and within
    rows and columns."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if kind == "normal":
        return x
    x *= np.exp(rng.uniform(-90, 90, (shape[0], 1))) * np.exp(rng.uniform(-5, 5, shape))
    x[0] = 0.0
    x[1, ::2] = 1e-300
    x[2, 1::3] = -1e300
    x[3] = np.where(np.arange(shape[1]) % 2, 1e-300, -3.0)
    x[:, 0] = 0.0
    x[:, 1] = 1e300
    x[5:, 2] = 1e-300
    return x


def _jax_flat(chunks, side: str, K: int) -> list[np.ndarray]:
    """The JAX package's bf16 (nc, M, kc) / (nc, kc, N) chunk limbs as
    flat (M, K) / (K, N) integer arrays."""
    out = []
    for c in chunks:
        c = np.asarray(c.astype(jnp.float32))
        if side == "A":
            out.append(c.transpose(1, 0, 2).reshape(c.shape[1], -1)[:, :K])
        else:
            out.append(c.reshape(-1, c.shape[2])[:K])
    return out


def _same_pre(tpre, jpre, side: str, K: int) -> bool:
    (td, ts), (jd, js) = tpre, jpre
    return (np.array_equal(ts.numpy(), np.asarray(js)) and len(td) == len(jd)
            and all(np.array_equal(a.numpy().astype(np.float32), b)
                    for a, b in zip(td, _jax_flat(jd, side, K))))


@pytest.mark.parametrize("L", [4, 5, 6, 7])
@pytest.mark.parametrize("kind", ["normal", "adversarial"])
def test_scales_and_digits_equal_jax(L, kind):
    """_pow2_scale and the digits of digitize_A / digitize_B are equal to
    the JAX package's (np.array_equal), and the digits bounded by 72."""
    A = _data(kind, (23, 41), seed=L)
    for side, (tfn, jfn) in {"A": (T.digitize_A, J.digitize_A),
                             "B": (T.digitize_B, J.digitize_B)}.items():
        x = A if side == "A" else A.T.copy()
        td, ts = tfn(_t(x), L)
        jd, js = jfn(jnp.asarray(x), L)
        assert np.array_equal(ts.numpy(), np.asarray(js)), side
        assert len(td) == len(jd) == L
        for a, b in zip(td, jd):
            assert a.dtype == torch.int8
            assert np.array_equal(a.numpy(), np.asarray(b)), side
            assert a.abs().max() <= 72
        for dim in (0, 1):
            assert np.array_equal(T._pow2_scale(_t(x), dim).numpy(),
                                  np.asarray(J._pow2_scale(jnp.asarray(x), dim)))


FLAT_ROUTES = ["direct", "A_dig", "B_dig", "A_pre", "B_pre", "both_pre", "int8_dtype"]


def _flat(route: str, pkg, A, B, L: int, maxdeg: int):
    if route == "direct":
        return pkg.exact_gemm(A, B, L=L, maxdeg=maxdeg)
    if route == "A_dig":
        return pkg.exact_gemm(B=B, A_dig=pkg.digitize_A(A, L), L=L, maxdeg=maxdeg)
    if route == "B_dig":
        return pkg.exact_gemm(A=A, B_dig=pkg.digitize_B(B, L), L=L, maxdeg=maxdeg)
    if route == "A_pre":
        return pkg.exact_gemm(B=B, A_pre=pkg.prechunk_A(A, L), maxdeg=maxdeg)
    if route == "B_pre":
        return pkg.exact_gemm(A=A, B_pre=pkg.prechunk_B(B, L), maxdeg=maxdeg)
    if route == "both_pre":
        return pkg.exact_gemm(A_pre=pkg.prechunk_A(A, L), B_pre=pkg.prechunk_B(B, L),
                              maxdeg=maxdeg)
    i8 = jnp.int8 if pkg is J else torch.int8
    return pkg.exact_gemm(A, B, L=L, maxdeg=maxdeg, digit_dtype=i8)


@pytest.mark.parametrize("route", FLAT_ROUTES)
def test_exact_gemm_flat_routes_bitwise(route):
    """Every flat-scale route equals the JAX package's bit for bit, at
    K = 1300 (three 512-chunks, padded), at the production L=6/maxdeg=7
    and at maxdeg 8 (the seventh degree-8 pair spills to a second group
    slot); the port's int8
    (_int_mm) and f32 routes give the same bits; the prechunked routes
    equal the direct one (pure precomputation)."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((37, 1300)) * np.exp(rng.uniform(-8, 8, (37, 1)))
    B = rng.standard_normal((1300, 29)) * np.exp(rng.uniform(-8, 8, (1, 29)))
    for L, maxdeg in ((5, 6), (6, 7), (7, 8)) if route == "direct" else ((6, 7), (7, 8)):
        # one compiled program per case: the JAX package's eager op-by-op
        # dispatch compiles every primitive on its own
        jflat = jax.jit(functools.partial(_flat, route, J, L=L, maxdeg=maxdeg))
        want = np.asarray(jflat(jnp.asarray(A), jnp.asarray(B)))
        got = _flat(route, T, _t(A), _t(B), L, maxdeg).numpy()
        assert np.array_equal(got, want), (L, maxdeg)
        if route != "int8_dtype":
            direct = T.exact_gemm(_t(A), _t(B), L=L, maxdeg=maxdeg).numpy()
            assert np.array_equal(got, direct), (L, maxdeg)
        assert np.abs(got - A @ B).max() <= 1e-9 * np.abs(A @ B).max()


def test_int8_route_equals_f32_route():
    """torch._int_mm and the chunked f32 matmul give the same digit-pair
    sums, so every result is the same on either route; an unknown route
    raises (nothing falls back to an f64 product)."""
    rng = np.random.default_rng(4)
    cases = [((5, 13), (13, 7)), ((17, 1030), (1030, 8)), ((64, 2048), (2048, 3))]
    for (sa, sb) in cases:
        A = _t(_data("adversarial" if sa[0] > 5 else "normal", sa, 1))
        B = _t(rng.standard_normal(sb))
        for kw in ({"L": 7, "maxdeg": 8}, {"L": 6, "maxdeg": 7, "digit_dtype": torch.int8}):
            a = T.exact_gemm(A, B, route="int8", **kw)
            b = T.exact_gemm(A, B, route="f32", **kw)
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), (sa, kw)
        ad, bd = T.digitize_A(A, 3)[0][0], T.digitize_B(B, 3)[0][2]
        exact = ad.to(torch.int64) @ bd.to(torch.int64)
        for route in T.ROUTES:
            assert torch.equal(T.digit_pair_gemm(ad, bd, route), exact.double())
    with pytest.raises(ValueError, match="digit route"):
        T.digit_pair_gemm(ad, bd, "bf16")


def test_int_mm_blocks_and_padding(monkeypatch):
    """_int_mm's zero padding (M to 32, K to 16s, N to 8s) and its blocks
    of at most _INT_MM_TILE rows and columns (lowered to 7 here) leave
    the integer product exact."""
    rng = np.random.default_rng(9)
    monkeypatch.setattr(T, "_INT_MM_TILE", 7)
    for M, K, N in ((1, 1, 1), (23, 30, 19), (40, 17, 8), (7, 16, 7)):
        a = torch.as_tensor(rng.integers(-72, 73, (M, K)), dtype=torch.int8)
        b = torch.as_tensor(rng.integers(-72, 73, (K, N)), dtype=torch.int8)
        got = T._int_mm(a, b)
        assert got.dtype == torch.int32 and got.shape == (M, N)
        assert torch.equal(got.long(), a.long() @ b.long())


def _letters(spec: str, o: int, v: int, nvs: str = "abcdef") -> tuple:
    """Operand shapes of an einsum spec: occupied letters i-n -> o,
    virtual letters a-f -> v."""
    ins = spec.split("->")[0].split(",")
    return tuple(tuple(v if c in nvs else o for c in s) for s in ins)


def _near_f64(got, ref, L: int) -> None:
    """A sanity bound beside the bitwise checks: the digit truncation at
    depth L is ~2^-7L of the row x column scale, summed over K."""
    assert np.abs(got.numpy() - ref).max() <= 2.0 ** (10 - 7 * L) * max(1.0, np.abs(ref).max())


XE_SPECS = ["je,ekia->jkia", "em,miea->ia", "ijae,eb->ijab", "imab,jm->ijab",
            "mnab,ijmn->ijab", "ma,ijmb->ijab", "mjae,iemb->ijab", "iema,mjeb->ijab",
            "miea,ejmb->ijab"]
SPATIAL_SITES = ([(s, "A") for s, _ in jsp._DIG_CONST_SPECS]
                 + [(s, "B") for s, _ in jsp._DIG_CONST_SPECS_B]
                 + [(s, "xe") for s in XE_SPECS])


def test_spatial_spec_tables_equal_jax():
    assert tsp._DIG_CONST_SPECS == jsp._DIG_CONST_SPECS
    assert tsp._DIG_CONST_SPECS_B == jsp._DIG_CONST_SPECS_B
    assert tsp._DIG_L == jsp._DIG_L


@pytest.mark.parametrize("spec,side", SPATIAL_SITES)
def test_exact_einsum_spatial_sites_bitwise(spec, side):
    """Each digit-GEMM call site of the restricted hybrid iteration at its
    depth (`_DIG_L`, L=6 default, maxdeg=7): the constant side's
    prechunk_op digits and scales, and the contraction, equal the JAX
    package's bit for bit."""
    rng = np.random.default_rng(sum(map(ord, spec)))
    sa, sb = _letters(spec, 3, 5)
    A, B = rng.standard_normal(sa), rng.standard_normal(sb)
    jA, jB, tA, tB = jnp.asarray(A), jnp.asarray(B), _t(A), _t(B)
    if side == "xe":
        want = J.exact_einsum(spec, jA, jB, L=6, maxdeg=7)
        got = T.exact_einsum(spec, tA, tB, L=6, maxdeg=7)
    else:
        L = jsp._DIG_L.get(spec, 6)
        arr = (jA, tA) if side == "A" else (jB, tB)
        jpre = J.prechunk_op(spec, side, arr[0], L=L)
        tpre = T.prechunk_op(spec, side, arr[1], L=L)
        M_or_K = tpre[0][0].shape[1] if side == "A" else tpre[0][0].shape[0]
        assert _same_pre(tpre, jpre, side, M_or_K)
        key = "A_pre" if side == "A" else "B_pre"
        want = J.exact_einsum(spec, jA, jB, maxdeg=7, **{key: jpre})
        got = T.exact_einsum(spec, tA, tB, maxdeg=7, **{key: tpre})
    assert np.array_equal(got.numpy(), np.asarray(want))
    _near_f64(got, np.einsum(spec, A, B), 6 if side == "xe" else jsp._DIG_L.get(spec, 6))


def _spin_operands(o: int = 4, v: int = 6, seed: int = 17) -> dict:
    rng = np.random.default_rng(seed)
    shapes = {"oooo": (o, o, o, o), "ooov": (o, o, o, v), "ovoo": (o, v, o, o),
              "oovo": (o, o, v, o), "oovv": (o, o, v, v), "ovvo": (o, v, v, o),
              "ovvv": (o, v, v, v), "vovv": (v, o, v, v), "vvvv": (v, v, v, v)}
    ops = {k: rng.standard_normal(s) * 0.1 for k, s in shapes.items()}
    for k in ("t1", "tau", "t2", "W", "F"):
        ops[k] = rng.standard_normal({"t1": (o, v), "F": (v, v), "W": (o, v, v, o)}.get(
            k, (o, o, v, v))) * 0.05
    return ops


# (spec, A operand, B operand, HybridConsts field or None, side, L)
SPINORB_SITES = [
    ("mf,mafe->ae", "t1", "ovvv", "ovvv_mf_ae_dig", "B", 5),
    ("mnaf,mnfe->ae", "tau", "oovv", "oovv_mnf_e_dig", "B", 4),
    ("ne,nmie->mi", "t1", "ooov", "ooov_ne_mi_dig", "B", 4),
    ("inef,mnef->mi", "tau", "oovv", "oovv_nef_m_dig", "B", 4),
    ("mnef,inef->mi", "tau", "oovv", "oovv_nef_m_dig", "B", 4),
    ("mnie,je->mnij", "ooov", "t1", "ooov_mni_e_dig", "A", 4),
    ("mnef,ijef->mnij", "oovv", "tau", "oovv_mn_dig", "A", 4),
    ("mbef,jf->mbej", "ovvv", "t1", "ovvv_mbe_dig", "A", 5),
    ("nb,nmej->mbej", "t1", "oovo", "oovo_n_mej_dig", "B", 4),
    ("mife,mafe->ia", "t2", "ovvv", "ovvv_mfe_a_dig", "B", 5),
    ("mnea,mnei->ia", "t2", "oovo", "oovo_mne_i_dig", "B", 4),
    ("ie,ejab->ijab", "t1", "vovv", "vovv_e_dig", "B", 5),
    ("ijbm,ma->ijab", "oovo", "t1", "oovo_ijb_m_dig", "A", 4),
    # `hs`: both operands digitized in the loop, L=5/maxdeg=6
    ("miea,mbej->ijab", "t2", "W", None, None, 5),
    ("ijae,be->ijab", "t2", "F", None, None, 5),
    ("mnij,mnab->ijab", "oooo", "tau", None, None, 5),
]


@pytest.fixture(scope="module", params=[False, True], ids=["resident", "in_loop"])
def spin_consts(request):
    """presplit_consts of both packages on the same random spin-orbital
    slices; "in_loop" lowers _OVVV_LIMB_BYTES to 0 in both, so the five
    ovvv-family sites digitize in the loop, as at the 116-bf dimer."""
    ops = _spin_operands()
    names = [f for f in jso.SpinSlices._fields if f != "vvvv_blocks"]
    jv = jso.SpinSlices(**{k: jnp.asarray(ops[k]) for k in names})
    tv = tso.SpinSlices(**{k: _t(ops[k]) for k in names})
    with pytest.MonkeyPatch.context() as mp:
        if request.param:
            mp.setattr(jso, "_OVVV_LIMB_BYTES", 0.0)
            mp.setattr(tso, "_OVVV_LIMB_BYTES", 0.0)
        # a fresh callable per param, so the byte rule is traced anew
        jc = jax.jit(lambda v: jso.presplit_consts(v))(jv)
        return ops, jv, tv, jc, tso.presplit_consts(tv), request.param


def test_presplit_consts_equal_jax(spin_consts):
    """Every HybridConsts field holds the JAX package's digits and scales
    (None in both above the byte rule)."""
    ops, _, _, jc, tc, big = spin_consts
    for name in jso.HybridConsts._fields:
        jpre, tpre = getattr(jc, name), getattr(tc, name)
        assert (jpre is None) == (tpre is None), name
        if tpre is None:
            assert big and "vv" in name
            continue
        side = "B" if tpre[1].shape[0] == 1 else "A"
        K = tpre[0][0].shape[1] if side == "A" else tpre[0][0].shape[0]
        assert _same_pre(tpre, jpre, side, K), name


@pytest.mark.parametrize("site", SPINORB_SITES, ids=[s[0] for s in SPINORB_SITES])
def test_exact_einsum_spinorb_sites_bitwise(spin_consts, site):
    """Each digit-GEMM call site of the spin-orbital hybrid iteration, as
    the iteration calls it (with the digitized constant, or in the loop
    at L=5 where the byte rule leaves it None, maxdeg=6), equals the JAX
    package's bit for bit."""
    spec, a, b, field, side, L = site
    ops, _, _, jc, tc, _ = spin_consts
    jA, jB, tA, tB = jnp.asarray(ops[a]), jnp.asarray(ops[b]), _t(ops[a]), _t(ops[b])
    kw = {"maxdeg": 6, "L": L}
    jkw, tkw = dict(kw), dict(kw)
    if field is not None:
        key = "A_pre" if side == "A" else "B_pre"
        jkw[key], tkw[key] = getattr(jc, field), getattr(tc, field)
    want = J.exact_einsum(spec, jA, jB, **jkw)
    got = T.exact_einsum(spec, tA, tB, **tkw)
    assert np.array_equal(got.numpy(), np.asarray(want))
    _near_f64(got, np.einsum(spec, ops[a], ops[b]), L if field is None or "vv" in field else 5)


def test_spinorb_gemm_sites_bitwise(spin_consts):
    """The three GEMM-level sites (w4, G, the blocked tau*vvvv) equal the
    JAX package's bit for bit with consts; without consts (split-f32)
    they hold the split route's bound."""
    ops, jv, tv, jc, tc, _ = spin_consts
    Z = ops["tau"]
    pairs = [
        (jso._w4_split(jv.oovv, jnp.asarray(Z), jc), tso._w4_split(tv.oovv, _t(Z), tc)),
        (jso._g_split(jnp.asarray(Z), jv.ovvv, jc), tso._g_split(_t(Z), tv.ovvv, tc)),
        (jso.tau_vvvv_split(jnp.asarray(Z), jv.vvvv, jc),
         tso.tau_vvvv_split(_t(Z), tv.vvvv, tc)),
    ]
    for want, got in pairs:
        assert np.array_equal(got.numpy(), np.asarray(want))
    dense = tso.tau_vvvv_blocked(_t(Z), tv.vvvv).numpy()
    for got in (tso.tau_vvvv_split(_t(Z), tv.vvvv, None).numpy(), pairs[2][1].numpy()):
        assert np.abs(got - dense).max() <= 1e-6 * np.abs(dense).max()


def test_chunkscaled_and_streamed_hold_tolerance():
    """prechunk_B_chunkscaled (per-chunk scales over an operand whose
    chunks span ten decades) through exact_gemm, exact_einsum with a
    shape-only operand and gemm_B_pre_streamed: within 1e-11 of scale of
    the f64 product (the JAX package's bound) and within 1e-14 of scale
    of the JAX package's results; its digits and scales equal JAX's;
    the f32 reconstruction within 2e-7 of scale."""
    rng = np.random.default_rng(12)
    K, N, M = 1536, 29, 17  # kc=512, nc=3
    B = rng.standard_normal((K, N))
    B[512:1024] *= 1e-6
    B[1024:] *= 1e4
    A = rng.standard_normal((M, K))
    ref = A @ B
    tp, jp = T.prechunk_B_chunkscaled(_t(B), L=6), J.prechunk_B_chunkscaled(jnp.asarray(B), L=6)
    assert np.array_equal(tp[1].numpy(), np.asarray(jp[1]))
    for a, b in zip(tp[0], jp[0]):
        assert np.array_equal(a.numpy().astype(np.float32), np.asarray(b.astype(jnp.float32)))
    scale = np.abs(ref).max()
    outs = {
        "exact_gemm": (T.exact_gemm(A=_t(A), B_pre=tp, maxdeg=7),
                       J.exact_gemm(A=jnp.asarray(A), B_pre=jp, L=6, maxdeg=7)),
        "streamed": (T.gemm_B_pre_streamed(_t(A), tp, maxdeg=7),
                     J.gemm_B_pre_streamed(jnp.asarray(A), jp, maxdeg=7)),
    }
    for name, (got, want) in outs.items():
        assert np.abs(got.numpy() - ref).max() < 1e-11 * scale, name
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-14 * scale, name
    f32 = T.exact_gemm(A=_t(A), B_pre=tp, maxdeg=7, route="f32")
    assert np.abs(f32.numpy() - outs["exact_gemm"][0].numpy()).max() <= 1e-14 * scale

    A4 = rng.standard_normal((3, 4, 32, 48))  # (i,j,e,f)
    B4 = rng.standard_normal((32, 48, 6, 8))  # (e,f,a,b), K=1536
    Bp4 = T.prechunk_B_chunkscaled(_t(B4.reshape(K, 48)), L=6)
    ref4 = np.einsum("ijef,efab->ijab", A4, B4)
    out4 = T.exact_einsum("ijef,efab->ijab", _t(A4), None, L=6, maxdeg=7, B_pre=Bp4,
                          B_shape=(32, 48, 6, 8))
    assert np.abs(out4.numpy() - ref4).max() < 1e-11 * np.abs(ref4).max()

    back = T.reconstruct_f32_from_B_pre(tp, K, N)
    assert back.dtype == torch.float32
    assert np.abs(back.numpy() - B).max() < 2e-7 * np.abs(B).max()
    assert np.array_equal(back.numpy(), np.asarray(J.reconstruct_f32_from_B_pre(jp, K, N)))


@pytest.mark.parametrize("spec", ["mnef,jnfb->mbej", "miea,mbej->ijab", "ijef,maef->ijma"])
def test_split_einsum_holds_jax_bound(spec):
    """split_einsum against the f64 einsum within the JAX package's bound
    (1e-6 of scale, tests/test_cc_solver.py), and within 1e-12 of scale of
    the JAX package's split_einsum (f32 roundings may associate
    differently); split_matmul with pre-split halves equals the plain
    call."""
    sa, sb = _letters(spec, 4, 6)
    rng = np.random.default_rng(7)
    A, B = rng.standard_normal(sa) * 0.05, rng.standard_normal(sb) * 0.1
    dense = np.einsum(spec, A, B)
    got = tsplit.split_einsum(spec, _t(A), _t(B)).numpy()
    scale = max(np.abs(dense).max(), 1e-30)
    assert np.abs(got - dense).max() / scale < 1e-6
    want = np.asarray(jsplit.split_einsum(spec, jnp.asarray(A), jnp.asarray(B)))
    assert np.abs(got - want).max() / scale < 1e-12
    Am, Bm = _t(rng.standard_normal((13, 70))), _t(rng.standard_normal((70, 9)))
    plain = tsplit.split_matmul(Am, Bm, 4)
    pre = tsplit.split_matmul(A_pre=tsplit._chunk_A(Am, 4), B_pre=tsplit._chunk_B(Bm, 4))
    assert torch.equal(plain, pre)


def _key(fn, *args, **kwargs):
    import inspect

    bound = inspect.signature(fn).bind(*args, **kwargs)
    bound.apply_defaults()
    return T._call_key(fn.__name__, bound.arguments)


def test_digit_graph_key_names_spec_shapes_and_prechunked_tensors():
    """The graph key of an entry call: the same for the same spec,
    arguments, operand shapes and prechunked tensors (whatever holds
    them); another for another spec, shape, dtype, non-tensor argument
    or prechunked tensor of equal value.  The varying operands are those
    the body reads."""
    rng = np.random.default_rng(3)
    A, B = _t(rng.standard_normal((4, 5, 6))), _t(rng.standard_normal((6, 3)))
    spec = "ijk,kl->ijl"
    pre = T.prechunk_op(spec, "B", B)
    key, varying, held = _key(T.exact_einsum, spec, A, B, B_pre=pre)
    assert varying == ["A"] and [id(t) for t in held] == [id(t) for t in T._tensors(pre)]
    assert _key(T.exact_einsum, spec, A.clone(), B.clone(), B_pre=(pre[0], pre[1]))[0] == key
    assert _key(T.exact_einsum, spec, A, B, B_pre=pre, maxdeg=5)[0] == key  # the default
    for other in (
        _key(T.exact_einsum, "ijk,kl->jil", A, B, B_pre=pre),
        _key(T.exact_einsum, spec, A[:3], B, B_pre=pre),
        _key(T.exact_einsum, spec, A.float(), B, B_pre=pre),
        _key(T.exact_einsum, spec, A, B, B_pre=pre, maxdeg=6),
        _key(T.exact_einsum, spec, A, B, B_pre=T.prechunk_op(spec, "B", B)),
        _key(T.exact_einsum, spec, A, B),
    ):
        assert other[0] != key
    assert _key(T.exact_einsum, spec, A, B)[1] == ["A", "B"]
    Am = A.reshape(20, 6)
    assert _key(T.exact_gemm, Am, B, L=5)[1] == ["A", "B"]
    assert _key(T.exact_gemm, Am, B_dig=T.digitize_B(B, 5))[1] == ["A"]
    assert _key(T.exact_gemm, A_pre=T.prechunk_A(Am), B=B)[1] == ["B"]
    assert _key(T.exact_gemm, Am, B)[0] != _key(T.exact_einsum, spec, A, B)[0]
    limbs = T.prechunk_B_chunkscaled(_t(rng.standard_normal((16, 3))))
    assert _key(T.gemm_B_pre_streamed, _t(rng.standard_normal((2, 16))), limbs)[1] == ["A"]


def _digit_graph_counts():
    g = T.graph_scope
    return [g.calls, g.captures, g.replays, T._int_mm.launches, T.digit_pair_gemm.launches]


def _entry_calls():
    """One call of each entry point on the CPU, with a prechunked, a
    pre-digitized and a chunk-scaled operand."""
    rng = np.random.default_rng(11)
    A, B = _t(rng.standard_normal((3, 4, 16))), _t(rng.standard_normal((16, 5)))
    pre, dig = T.prechunk_op("ijk,kl->ijl", "B", B), T.digitize_B(B, 6)
    limbs = T.prechunk_B_chunkscaled(B)
    Am = A.reshape(12, 16)
    return [
        lambda: T.exact_einsum("ijk,kl->ijl", A, B, B_pre=pre, maxdeg=6),
        lambda: T.exact_einsum("ijk,kl->lji", A, B, L=5),
        lambda: T.exact_gemm(Am, B_dig=dig, L=6, maxdeg=7),
        lambda: T.exact_gemm(Am, B, digit_dtype=torch.int8),
        lambda: T.gemm_B_pre_streamed(Am, limbs, maxdeg=6),
    ]


def test_digit_graph_scope_is_a_no_op_off_the_card():
    """On the CPU a graph scope changes nothing: every entry point gives
    the same bits and launches as without it, no digit_graph counter
    moves, and nothing is captured."""
    calls = _entry_calls()
    before = _digit_graph_counts()
    want = [f() for f in calls]
    eager = [a - b for a, b in zip(_digit_graph_counts(), before)]
    before = _digit_graph_counts()
    with T.graph_scope():
        got = [[f() for f in calls] for _ in range(3)]
        assert T._scope.graphs == {} and T._scope.met == {}
    counts = [a - b for a, b in zip(_digit_graph_counts(), before)]
    assert counts == [0, 0, 0] + [3 * n for n in eager[3:]] and eager[3] > 0
    for g in got:
        assert all(torch.equal(x, w) and x.stride() == w.stride() for x, w in zip(g, want))


def test_digit_graph_scope_closes_on_an_exception():
    """A scope closes on every exit, an exception's included, and a CC
    solve's loop runs inside one; a scope opened inside an open one is
    the outer one's."""
    from afesp_tpu_torch.ops import cc_step

    with pytest.raises(KeyError):
        with T.graph_scope():
            outer = T._scope
            with T.graph_scope():
                assert T._scope is outer
            assert T._scope is outer
            raise KeyError("x")
    assert T._scope is None

    seen = []

    def iteration_fn(t1, t2, v, D_ia, D_ijab, consts):
        seen.append(T._scope)
        raise RuntimeError("iteration failed")

    solve = cc_step.make_cc_solver(iteration_fn, lambda *a: None)
    t = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="iteration failed"):
        solve(cc_step.init_cc_state(t, t, 3), None, None, None, None, 0.0, 1e-6, 1e-6,
              nerr=3, maxiter=4)
    assert len(seen) == 1 and seen[0] is not None and T._scope is None


class _ReplayedGraph:
    """A stand-in for a captured graph on the CPU: its "capture" runs the
    body once (the launch counters rise once, as under a real capture),
    its replay runs the body again with the counters put back."""

    def __init__(self, fn, bound, varying, held, pool, side):
        self.fn, self.signature, self.held = fn, bound.signature, held
        before = T._launches()
        fn(*bound.args, **bound.kwargs)
        self.counts = [a - b for a, b in zip(T._launches(), before)]

    def replay(self, arguments):
        import inspect

        counts = T._launches()
        b = inspect.BoundArguments(self.signature, arguments)
        out = self.fn(*b.args, **b.kwargs)
        T._int_mm.launches, T.digit_pair_gemm.launches = counts
        return out


def test_digit_graph_scope_meets_captures_and_replays(monkeypatch):
    """The scope's bookkeeping, with the card and its graphs stood in
    for: each outermost call's first meeting runs eagerly, the second
    captures and replays, later ones replay; calls made inside another
    entry point are not met; the launch counters rise as the eager
    calls' would; a key whose prechunked tensor has died is met anew."""
    monkeypatch.setattr(T, "_card_of", lambda args, kwargs: 0)
    monkeypatch.setattr(T, "_Graph", _ReplayedGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(T, "_side_stream", lambda: None)
    calls = _entry_calls()
    before = _digit_graph_counts()
    want = [f() for f in calls]
    eager = [a - b for a, b in zip(_digit_graph_counts(), before)]
    before = _digit_graph_counts()
    with T.graph_scope():
        got = [[f() for f in calls] for _ in range(4)]
        scope = T._scope
        assert len(scope.graphs) == len(calls) and scope.met == {} and scope.pool == "pool"
    counts = [a - b for a, b in zip(_digit_graph_counts(), before)]
    n = len(calls)
    assert counts == [4 * n, n, 2 * n] + [4 * k for k in eager[3:]]
    assert scope.graphs == {} and scope.pool is None
    for g in got:
        assert all(torch.equal(x, w) for x, w in zip(g, want))

    rng = np.random.default_rng(5)
    A, B = _t(rng.standard_normal((6, 16))), _t(rng.standard_normal((16, 5)))
    before = _digit_graph_counts()
    with T.graph_scope():
        for _ in range(2):  # a new prechunked B each call: never met twice
            T.exact_gemm(A, B_pre=T.prechunk_B(B))
        assert T._scope.graphs == {}
    assert [a - b for a, b in zip(_digit_graph_counts(), before)][:3] == [2, 0, 0]
