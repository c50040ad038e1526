"""Port parity: the streaming-slices tier of the restricted path
(AFESP_FORCE_STREAM=1) against the JAX package, on the CPU.

Each piece on the same seeded numpy inputs: the sliced AO->MO transform
(slices within 1e-12 of scale, and with digit_L=5 the vvvv limbs and
their per-chunk scales equal to JAX's, over several chunk geometries),
the stream Fock consts (digits and scales equal) and build (1e-12),
Palser-Manolopoulos purification (1e-12, the same step count), the
device SCF prelude (the same iteration count, the Fock matrix within
1e-10) and the CR term from the limbs (1e-12 of scale).  Then both
drivers on the 24-bf H2O at CRCCSD(T)_spatial, "hybrid", forced to
stream, with the HF dense and, with _TPU_FOCK_NBASIS at 20 in both
packages, through the stream Fock build and the prelude: the reports
equal line for line with the timings masked and each number within
1e-10, equal counts, CCSD within 1e-10 and the six triples energies
within 1e-10 of JAX's f64 triples on JAX's own amplitudes and CR term
(both drivers' triples called at precision="f64": their CPU tier at
"hybrid" is the f32 one, held in tests/test_torch_triples_hybrid.py).
And the two refusals of the tier, with JAX's exception and message.
"""

import functools
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fixtures import table_energies, write_els_in, write_h2o

import afesp_tpu.driver as jdriver
import afesp_tpu_torch.driver as tdriver
from afesp_tpu.io.report import Reporter as JaxReporter
from afesp_tpu.methods import ccsd_spatial as jsp
from afesp_tpu.methods import hf as jhf
from afesp_tpu.methods import mo_slices as jms
from afesp_tpu.methods.triples_spatial import do_ccsd_t_spatial as jax_ccsd_t_spatial
from afesp_tpu.ops.exact_gemm import prechunk_B_chunkscaled as jax_chunkscaled
from afesp_tpu.ops.packed_eri import pack_eri
from afesp_tpu_torch.driver import run_calculation
from afesp_tpu_torch.io.report import Reporter
from afesp_tpu_torch.methods import ccsd_spatial as tsp
from afesp_tpu_torch.methods import hf as thf
from afesp_tpu_torch.methods import mo_slices as tms
from afesp_tpu_torch.methods import tiers as ttiers
from afesp_tpu_torch.methods.triples_spatial import do_ccsd_t_spatial as port_ccsd_t_spatial

_t = torch.from_numpy


def _symmetric_eri(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, n, n, n))
    e = e + e.transpose(1, 0, 2, 3)
    e = e + e.transpose(0, 1, 3, 2)
    e = e + e.transpose(2, 3, 0, 1)
    return e / 8.0


def _sym(rng, n):
    A = rng.standard_normal((n, n))
    return (A + A.T) / 2.0


def _limbs_equal(port, jax_form) -> bool:
    (pl, ps), (jl, js) = port, jax_form
    return (len(pl) == len(jl)
            and all(np.array_equal(p.numpy(), np.asarray(j).astype(np.int8))
                    for p, j in zip(pl, jl))
            and np.array_equal(ps.numpy(), np.asarray(js)))


# (n, nocc, virtual rows per chunk or None for the default budget,
#  group_bytes of the port's stage-1 passes)
GEOMETRIES = [(12, 4, None, 2e9), (10, 3, None, 2e9), (12, 4, 2, 1.0)]


@pytest.mark.parametrize("n,nocc,nr,group_bytes", GEOMETRIES)
def test_ao_to_mo_slices_match_jax(n, nocc, nr, group_bytes, monkeypatch):
    """Slices within 1e-12 of scale of JAX's (f64 vvvv with digit_L None),
    and with digit_L=5 the limbs and scales equal to JAX's, at the
    default chunk and at forced small chunks (several limb chunks, and
    several stage-1 passes of the port)."""
    if nr is not None:
        for mod in (jms, tms):
            monkeypatch.setattr(mod, "_pick_chunk", lambda nvirt, n_, k=nr: k)
    monkeypatch.setattr(tms, "_GROUP_BYTES", group_bytes)
    eri = _symmetric_eri(n, seed=7 + n)
    C = np.random.default_rng(8 + n).standard_normal((n, n)) / np.sqrt(n)
    packed = pack_eri(eri)
    ref, ref_vvvv = jms.ao_to_mo_slices(jnp.asarray(packed), jnp.asarray(C), n=n, nocc=nocc)
    out, vvvv = tms.ao_to_mo_slices(_t(packed), _t(C), n=n, nocc=nocc)
    assert out.v_vvvv is None and ref.v_vvvv is None
    for name in ("v_oovv", "v_ovov", "v_vvov", "v_oovo", "v_oooo"):
        r = np.asarray(getattr(ref, name))
        o = getattr(out, name).numpy()
        assert o.shape == r.shape
        assert np.abs(o - r).max() <= 1e-12 * max(np.abs(r).max(), 1.0), name
    r = np.asarray(ref_vvvv)
    assert np.abs(vvvv.numpy() - r).max() <= 1e-12 * max(np.abs(r).max(), 1.0)

    jout, jform = jms.ao_to_mo_slices(jnp.asarray(packed), jnp.asarray(C), n=n, nocc=nocc,
                                      digit_L=5)
    tout, tform = tms.ao_to_mo_slices(_t(packed), _t(C), n=n, nocc=nocc, digit_L=5)
    assert _limbs_equal(tform, jform)
    assert np.array_equal(tout.v_vvov.numpy(), np.asarray(jout.v_vvov))
    if nr is not None:  # per-chunk scales: not the limbs of the whole operand
        nv = n - nocc
        whole = jax_chunkscaled(jnp.asarray(r.reshape(nv * nv, nv * nv)), L=5)
        assert whole[1].shape != jform[1].shape


def test_fock_stream_consts_and_build_match_jax():
    """The gathered stream consts equal JAX's digit for digit and scale
    for scale; the build within 1e-12 of scale of JAX's, whole and as the
    packed upper triangle (f64 and the early f32 form)."""
    n = 14
    eri = _symmetric_eri(n, seed=5)
    packed = pack_eri(eri)
    rng = np.random.default_rng(6)
    H = _sym(rng, n)
    Cc = rng.standard_normal((n // 2, n))
    D = Cc.T @ Cc
    tk, tl = np.tril_indices(n)
    jtk, jtl = jnp.asarray(tk.astype(np.int32)), jnp.asarray(tl.astype(np.int32))
    ttk, ttl = _t(tk), _t(tl)
    jc = jhf._fock_stream_consts(jnp.asarray(packed), jtk, jtl, n=n)
    tc = thf._fock_stream_consts(_t(packed), ttk, ttl, n=n)
    for (jd, js), (td, ts) in zip(jc, tc):
        assert len(jd) == len(td) == 6
        assert all(np.array_equal(t.numpy(), np.asarray(j)) for t, j in zip(td, jd))
        assert np.array_equal(ts.numpy(), np.asarray(js))

    ref = np.asarray(jhf._fock_build_stream(jnp.asarray(H), jnp.asarray(D), jc, jtk, jtl))
    out = thf._fock_build_stream(_t(H), _t(D), tc, ttk, ttl).numpy()
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(out - ref).max() <= 1e-12 * scale
    dense = H + 2.0 * np.einsum("ijkl,kl->ij", eri, D) - np.einsum("ikjl,kl->ij", eri, D)
    assert np.abs(out - dense).max() <= 1e-11 * scale
    iu = np.triu_indices(n)
    for f32 in (False, True):
        jp = np.asarray(jhf._fock_build_stream(
            jnp.asarray(H), jnp.asarray(D), jc, jtk, jtl,
            (jnp.asarray(iu[0]), jnp.asarray(iu[1])), packed_f32=f32))
        tp = thf._fock_build_stream(_t(H), _t(D), tc, ttk, ttl, (_t(iu[0]), _t(iu[1])),
                                    packed_f32=f32).numpy()
        assert tp.dtype == jp.dtype
        tol = 2.0 ** -23 if f32 else 1e-12
        assert np.abs(tp.astype(np.float64) - jp).max() <= tol * scale


@pytest.mark.parametrize("m,nocc,seed", [(12, 3, 1), (20, 7, 2)])
def test_purify_density_matches_jax(m, nocc, seed):
    """The purified projector within 1e-12 of JAX's, after the same
    number of steps, and idempotent with trace nocc."""
    rng = np.random.default_rng(seed)
    Fp = np.diag(np.linspace(-2.0, 3.0, m)) + 0.1 * _sym(rng, m)
    Dj, nj = jhf.purify_density(jnp.asarray(Fp), nocc=nocc)
    Dt, nt = thf.purify_density(_t(Fp), nocc=nocc)
    assert nt == int(nj)
    assert np.abs(Dt.numpy() - np.asarray(Dj)).max() <= 1e-12
    D = Dt.numpy()
    assert abs(np.trace(D) - nocc) < 1e-10 and np.abs(D @ D - D).max() < 1e-10


def test_scf_prelude_matches_jax():
    """The device SCF prelude on stream consts: the same iteration count
    as JAX's, and its Fock matrix within 1e-10 of scale."""
    n, nocc = 12, 3
    eri = 0.1 * _symmetric_eri(n, seed=13)  # weak enough to converge
    rng = np.random.default_rng(14)
    H = np.diag(np.linspace(-3.0, 2.0, n)) + 0.05 * _sym(rng, n)
    S = np.eye(n) + 0.01 * _sym(rng, n)
    X = jhf.symmetric_orthogonaliser_np(S)
    iu = np.triu_indices(n)
    tk, tl = np.tril_indices(n)
    packed = pack_eri(eri)
    jtk, jtl = jnp.asarray(tk.astype(np.int32)), jnp.asarray(tl.astype(np.int32))
    jc = jhf._fock_stream_consts(jnp.asarray(packed), jtk, jtl, n=n)
    fj, itj = jhf._scf_prelude_device(
        jnp.asarray(H), jnp.asarray(S), jnp.asarray(X), jc,
        (jnp.asarray(iu[0]), jnp.asarray(iu[1])), jtk, jtl,
        nocc=nocc, nerr=6, maxiter=40, stream=True)
    tc = thf._fock_stream_consts(_t(packed), _t(tk), _t(tl), n=n)
    ft, itt = thf._scf_prelude_device(
        _t(H), _t(S), _t(X), tc, (_t(iu[0]), _t(iu[1])), _t(tk), _t(tl),
        nocc=nocc, nerr=6, maxiter=40)
    fj = np.asarray(fj)
    assert 1 < itt == int(itj) < 40
    assert np.abs(ft.numpy() - fj).max() <= 1e-10 * max(np.abs(fj).max(), 1.0)


def test_cr_vvvv_term_from_limbs_matches_jax():
    """es("ecba,ie->ciab", v_vvvv, t1) from per-chunk limbs: within 1e-12
    of scale of JAX's streamed GEMM on the same limbs."""
    o, nv = 3, 8
    rng = np.random.default_rng(21)
    vvvv = rng.standard_normal((nv,) * 4)
    t1 = 0.05 * rng.standard_normal((o, nv))
    B = vvvv.reshape(nv * nv, nv * nv)
    limbs = [jax_chunkscaled(jnp.asarray(B[c * 16:(c + 1) * 16]), L=5) for c in range(4)]
    jB = ([jnp.concatenate([b[0][d] for b in limbs]) for d in range(5)],
          jnp.concatenate([b[1] for b in limbs]))
    tB = ([_t(np.array(x).astype(np.int8)) for x in jB[0]], _t(np.array(jB[1])))
    ref = np.asarray(jsp._cr_vvvv_term_from_B(jnp.asarray(t1), jB, nv=nv))
    out = tsp._cr_vvvv_term_from_B(_t(t1), tB, nv=nv).numpy()
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(out - ref).max() <= 1e-12 * scale
    assert np.abs(out - np.einsum("ecba,ie->ciab", vvvv, t1)).max() <= 1e-9 * scale


# -- the driver ------------------------------------------------------------

_TIME = re.compile(r"(Time taken[^:]*:|Total execution time:)\s*[-\d.]+")
_DATE = re.compile(r"running on \S+ at \S+")
_ROW = re.compile(r"^(\s+(?:\d+|MP1)(?:\s+-?\d+\.\d+){3})\s+\d+\.\d+$")
_NUM = re.compile(r"-?\d+\.\d+(?:[eE][-+]?\d+)?")
STREAM = 'ccsd_precision = "hybrid",\nwrite_fcidump = .true.,\n'


def _masked(text: str):
    """The report with timings and dates masked, and each line's numbers
    taken out as (value, one unit of its last printed decimal)."""
    lines, nums = [], []
    for ln in text.split("\n"):
        ln = _DATE.sub("running on <date>", _TIME.sub(r"\1 <t>", ln))
        ln = _ROW.sub(r"\1 <t>", ln)
        nums.append([(float(x), 10.0 ** -len(x.split(".")[1].split("e")[0].split("E")[0]))
                     for x in _NUM.findall(ln)])
        # the padding before a number shifts with its sign, which a delta
        # of ~1e-13 may flip
        lines.append(re.sub(r"\s*" + _NUM.pattern, " <n>", ln))
    return lines, nums


@pytest.fixture(scope="module")
def h2o(tmp_path_factory):
    return write_h2o(tmp_path_factory.mktemp("h2o"))


def _stage(wd, h2o, calc, extra):
    for f in h2o.iterdir():
        if f.name != "els.in":
            (wd / f.name).symlink_to(f)
    write_els_in(wd, calc, extra)
    return wd


def _jax_run(wd):
    """The JAX driver with its spatial triples at f64 (on its own stream
    amplitudes and CR term)."""
    rep = JaxReporter(stream=io.StringIO())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdriver, "do_ccsd_t_spatial",
                   functools.partial(jax_ccsd_t_spatial, precision="f64"))
        res = jdriver.run_calculation(wd, rep)
    return res, rep.stream.getvalue()


@pytest.mark.parametrize("stream_fock", [False, True], ids=["dense_hf", "stream_hf"])
def test_driver_stream_tier_matches_jax(tmp_path, h2o, monkeypatch, stream_fock):
    monkeypatch.setenv("AFESP_FORCE_STREAM", "1")
    if stream_fock:
        monkeypatch.setattr(jhf, "_TPU_FOCK_NBASIS", 20)
        monkeypatch.setattr(ttiers, "_TPU_FOCK_NBASIS", 20)
    wd = _stage(tmp_path, h2o, "CRCCSD(T)_spatial", STREAM)
    jres, jtext = _jax_run(wd)
    rep = Reporter(stream=io.StringIO())
    monkeypatch.setattr(tdriver, "do_ccsd_t_spatial",
                        functools.partial(port_ccsd_t_spatial, precision="f64"))
    res = run_calculation(wd, rep, device="cpu")
    text = rep.stream.getvalue()

    # the stream tier ran in both (its FCIDUMP line below): no dense MO
    # tensor, v_vvvv as limbs
    assert res.cc.slices.v_vvvv is None
    assert res.cc.cr_vvvv_term is not None and res.cc.precision_used == "hybrid"
    assert res.sys.nbasis == 24 and not (tmp_path / "FCIDUMP").exists()
    for t in (text, jtext):
        assert t.count("FCIDUMP skipped: no dense MO tensor on the streaming tier.") == 1
        assert (" Device SCF prelude:" in t) == stream_fock

    assert res.cc.converged
    assert res.hf.iterations == len(table_energies(jtext, "delta RMS D"))
    assert res.cc.iterations == len(table_energies(jtext, "delta RMS T2"))
    assert abs(res.e_ccsd - jres.e_ccsd) < 1e-10
    assert abs(res.e_mp2 - jres.e_mp2) < 1e-10
    for k in ("e_ccsd_t", "e_ccsd_tt", "e_rccsd_t", "e_rccsd_tt", "e_crccsd_t", "e_crccsd_tt",
              "D_T", "D_TT"):
        assert abs(getattr(res.triples, k) - getattr(jres.triples, k)) < 1e-10, k

    lines, nums = _masked(text)
    jlines, jnums = _masked(jtext)
    assert lines == jlines
    # each number within 1e-10, or, where the report prints it to ten
    # decimals, within one unit of its last digit (a value 1e-12 from
    # JAX's can round the other way)
    for got, want, line in zip(nums, jnums, lines):
        assert len(got) == len(want)
        assert all(abs(a - b) <= max(1e-10, 1.001 * u) for (a, u), (b, _) in zip(got, want)), \
            (line, got, want)


@pytest.mark.parametrize("calc,extra,exc", [
    ("CCSD(T)_spinorb", 'ccsd_precision = "hybrid",\n', ValueError),
    ("CRCCSD(T)_spatial", 'ccsd_precision = "f64",\n', AssertionError),
], ids=["spinorb", "f64"])
def test_stream_tier_refusals_match_jax(tmp_path, h2o, monkeypatch, calc, extra, exc):
    """The spin-orbital CCSD and an all-f64 CCSD are refused on the
    stream tier with the JAX package's exception and message."""
    monkeypatch.setenv("AFESP_FORCE_STREAM", "1")
    wd = _stage(tmp_path, h2o, calc, extra)
    with pytest.raises(exc) as jerr:
        jdriver.run_calculation(wd, JaxReporter(stream=io.StringIO()))
    with pytest.raises(exc) as terr:
        run_calculation(wd, Reporter(stream=io.StringIO()), device="cpu")
    assert str(terr.value) == str(jerr.value) and str(terr.value)
