"""Port parity: the spin-orbital large-system tier of afesp_tpu_torch
(the Sz-blocked einsum, the block-compressed vvvv store and its
self-check) and the two repaired faults (the triples tier taken from
`ccsd_precision`, the `io` package's exports), against the JAX package
on seeded inputs and the generated 24-bf H2O, on the CPU."""

import importlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fixtures import breakdown_block, write_els_in, write_h2o

import afesp_tpu.driver as jdriver
import afesp_tpu.io as jio
from afesp_tpu.config import read_els_in
from afesp_tpu.io import dat as jdat
from afesp_tpu.io.report import Reporter as JaxReporter
from afesp_tpu.methods import ccsd_spinorb as jcc
from afesp_tpu.methods.hf import do_rhf
from afesp_tpu.methods.mp2 import do_mp2_spatial
from afesp_tpu.ops import spin as jspin
from afesp_tpu.ops.spin_einsum import spin_blocked_einsum as jax_blocked
from afesp_tpu_torch import config as tcfg
from afesp_tpu_torch.convert import from_jax
from afesp_tpu_torch.driver import run_calculation
from afesp_tpu_torch.io.report import Reporter
from afesp_tpu_torch.methods import ccsd_spinorb as tcc
from afesp_tpu_torch.methods.triples_spinorb import do_ccsd_t_spinorb
from afesp_tpu_torch.ops import spin as tspin
from afesp_tpu_torch.ops.spin_einsum import spin_blocked_einsum

F64 = torch.float64

# every (spec, operand kinds) that the port's _iteration_core passes to
# spin_blocked_einsum, as the JAX f64 iteration does (`bs`/`hs`)
O, V = 4, 6
KINDS = {"t1": "ov", "t2": "oovv", "oovv": "oovv", "ovvv": "ovvv", "ooov": "ooov",
         "vovv": "vovv", "ovvo": "ovvo", "oooo": "oooo", "vv": "vv"}
SPECS = [
    ("mf,mafe->ae", "t1", "ovvv"),
    ("mnaf,mnfe->ae", "t2", "oovv"),
    ("inef,mnef->mi", "t2", "oovv"),
    ("mnef,inef->mi", "t2", "oovv"),
    ("ne,nmie->mi", "t1", "ooov"),
    ("mnef,ijef->mnij", "oovv", "t2"),
    ("mbef,jf->mbej", "ovvv", "t1"),
    ("mnef,jnfb->mbej", "oovv", "t2"),
    ("mife,mafe->ia", "t2", "ovvv"),
    ("miea,mbej->ijab", "t2", "ovvo"),
    ("ijae,be->ijab", "t2", "vv"),
    ("ie,ejab->ijab", "t1", "vovv"),
    ("mnij,mnab->ijab", "oooo", "t2"),
    ("ijef,maef->ijma", "t2", "ovvv"),
]


def _sz_tensor(rng, kind: str) -> np.ndarray:
    """A seeded block-spin tensor with its forbidden Sz blocks zeroed."""
    shape = [2 * (O if c == "o" else V) for c in KINDS[kind]]
    x = rng.standard_normal(shape)
    s = np.ix_(*[(np.arange(n) >= n // 2).astype(int) for n in shape])
    keep = s[0] == s[1] if len(shape) == 2 else s[0] + s[1] == s[2] + s[3]
    return x * keep


@pytest.mark.parametrize("spec,a,b", SPECS, ids=[s[0] for s in SPECS])
def test_spin_blocked_einsum_matches_jax(spec, a, b):
    rng = np.random.default_rng(11)
    x, y = _sz_tensor(rng, a), _sz_tensor(rng, b)
    got = spin_blocked_einsum(spec, torch.as_tensor(x), torch.as_tensor(y)).numpy()
    want = np.asarray(jax_blocked(spec, jnp.asarray(x), jnp.asarray(y)))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 1e-13
    # and the dense contraction, since the skipped blocks are exact zeros
    assert np.max(np.abs(got - np.einsum(spec, x, y))) < 1e-13


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    wd = write_h2o(tmp_path_factory.mktemp("h2o"))
    cfg = read_els_in(wd)
    sys_, ints = jdat.read_integrals(wd, cfg.restricted)
    rep = JaxReporter(stream=io.StringIO())
    hf = do_rhf(sys_, ints, cfg, rep, wd)
    mp2 = do_mp2_spatial(sys_, ints, cfg, hf, rep, wd)
    return dict(wd=wd, sys_=sys_, hf=hf, eri_mo=np.array(mp2.eri_mo))


def test_vvvv_blocks_match_jax(stages):
    """The (aa, ab) blocks equal JAX's and the dense slice's own blocks
    bit for bit; the f32 block self-check agrees with JAX's."""
    nocc = stages["sys_"].nel // 2
    eri = torch.as_tensor(stages["eri_mo"])
    aa, ab = tspin.spinorb_vvvv_blocks(eri, nocc)
    jaa, jab = jspin.spinorb_vvvv_blocks(jnp.asarray(stages["eri_mo"]), nocc)
    assert np.array_equal(aa.numpy(), np.asarray(jaa))
    assert np.array_equal(ab.numpy(), np.asarray(jab))
    assert aa.is_contiguous() and ab.is_contiguous()
    dense = tspin.spinorb_slice(eri, "vvvv", nocc)
    vs = aa.shape[0]
    assert np.array_equal(dense[:vs, :vs, :vs, :vs].numpy(), aa.numpy())
    assert np.array_equal(dense[vs:, vs:, vs:, vs:].numpy(), aa.numpy())
    assert np.array_equal(dense[:vs, vs:, :vs, vs:].numpy(), ab.numpy())

    sl = tcc.make_spin_slices(eri, nocc, block_vvvv=True)
    assert sl.vvvv is None
    err = float(tspin.spin_symmetry_error_blocks(sl.oooo, sl.oovv, aa, ab))
    jerr = float(jspin.spin_symmetry_error_blocks(
        jnp.asarray(sl.oooo.numpy()), jnp.asarray(sl.oovv.numpy()), jaa, jab))
    # both are f32 sums of roundoff-level asymmetries, in different orders
    assert err < 1e-10 and jerr < 1e-10
    assert abs(err - jerr) <= 1e-2 * max(err, jerr) + 1e-15
    # a broken block trips it
    bad = ab.clone()
    bad[0, 1, 2, 3] += 1e-3
    assert float(tspin.spin_symmetry_error_blocks(sl.oooo, sl.oovv, aa, bad)) > 1e-4


@pytest.fixture(scope="module")
def dense_and_block(stages):
    """The port's spin-orbital CCSD in dense and in block mode (forced by
    lowering the byte rule, as tests/test_ccsd_spinorb.py does for JAX),
    and JAX's block mode on the same MO tensor."""
    st = from_jax(device="cpu", sys_=stages["sys_"], hf=stages["hf"])
    eri = torch.as_tensor(stages["eri_mo"], dtype=F64)
    cfg = tcfg.read_els_in(stages["wd"])
    run = lambda: tcc.do_ccsd_spinorb(st["sys_"], eri, cfg, st["hf"],  # noqa: E731
                                      Reporter(stream=io.StringIO()), stages["wd"],
                                      device="cpu")
    dense = run()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcc, "_BLOCK_VVVV_BYTES", 0.0)
        block = run()
        mp.setattr(jcc, "_BLOCK_VVVV_BYTES", 0.0)
        jblock = jcc.do_ccsd_spinorb(stages["sys_"], jnp.asarray(stages["eri_mo"]),
                                     read_els_in(stages["wd"]), stages["hf"],
                                     JaxReporter(stream=io.StringIO()), stages["wd"])
    return dict(st=st, cfg=cfg, dense=dense, block=block, jblock=jblock)


def test_block_mode_ccsd_matches_jax_and_dense(dense_and_block):
    d, b, j = (dense_and_block[k] for k in ("dense", "block", "jblock"))
    assert d.slices.vvvv is not None and d.slices.vvvv_blocks is None
    assert b.slices.vvvv is None and j.slices.vvvv is None
    assert b.converged and d.converged and j.converged
    assert b.iterations == d.iterations == j.iterations
    assert abs(b.e_ccsd - j.e_ccsd) < 1e-10
    assert abs(b.e_ccsd - d.e_ccsd) < 1e-10


def test_from_jax_carries_block_slices(dense_and_block):
    """JAX's block-mode slices convert with vvvv None and both blocks
    bit for bit."""
    j = dense_and_block["jblock"]
    sl = from_jax(device="cpu", cc=j)["cc"].slices
    assert sl.vvvv is None and len(sl.vvvv_blocks) == 2
    for got, want in zip(sl.vvvv_blocks, j.slices.vvvv_blocks):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_block_mode_triples_match_dense(dense_and_block, stages):
    st = dense_and_block["st"]
    e = {k: do_ccsd_t_spinorb(st["sys_"], dense_and_block[k], dense_and_block["cfg"],
                              stages["hf"].levels, Reporter(stream=io.StringIO()))
         for k in ("dense", "block")}
    assert abs(e["block"] - e["dense"]) < 1e-10


def test_block_rule_is_four_gigabytes():
    """The switch is JAX's: (2 nvirt)^4 f64 above 4e9 bytes."""
    assert tcc._BLOCK_VVVV_BYTES == jcc._BLOCK_VVVV_BYTES == 4e9
    # the water dimer's 212 virtual spin orbitals are over it, pVTZ's 106 not
    assert 212**4 * 8 > tcc._BLOCK_VVVV_BYTES > 106**4 * 8


@pytest.fixture(scope="module")
def h2o_spatial(tmp_path_factory):
    return write_h2o(tmp_path_factory.mktemp("h2o_sp"), "CRCCSD(T)_spatial")


@pytest.mark.parametrize("precision", ["pallas", "fused"])
def test_ccsd_precision_picks_the_triples_tier(h2o_spatial, precision):
    """`ccsd_precision` in els.in chooses the restricted triples tier as
    in the JAX driver; on the CPU the tiers run their kernels' plain
    versions."""
    write_els_in(h2o_spatial, "CRCCSD(T)_spatial", f'ccsd_precision = "{precision}",\n')
    jrep = JaxReporter(stream=io.StringIO())
    jres = jdriver.run_calculation(h2o_spatial, jrep)
    rep = Reporter(stream=io.StringIO())
    res = run_calculation(h2o_spatial, rep, device="cpu")
    assert res.triples.precision_used == jres.triples.precision_used == precision
    got = breakdown_block(rep.stream.getvalue())
    want = breakdown_block(jrep.stream.getvalue())
    assert [g.rpartition(" ")[0] for g in got] == [w.rpartition(" ")[0] for w in want]
    vals = [(float(g.rpartition(" ")[2]), float(w.rpartition(" ")[2]))
            for g, w in zip(got, want) if g.rstrip().endswith(tuple("0123456789"))]
    assert len(vals) >= 10
    assert max(abs(a - b) for a, b in vals) < 1e-8


def test_io_exports_match_jax():
    import afesp_tpu_torch.io as tio

    assert tio.__all__ == jio.__all__
    for name in tio.__all__:
        assert getattr(importlib.import_module("afesp_tpu_torch.io"), name) is getattr(tio, name)
    from afesp_tpu_torch.io import read_integrals, write_fcidump  # noqa: F401
