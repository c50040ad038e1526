"""Port parity: afesp_tpu_torch.flops against afesp_tpu.flops, function
by function, on a grid of sizes and precisions.  Plain arithmetic on
integers and floats: the counts must be equal (the same expressions in
the same order)."""

import itertools

import pytest

from afesp_tpu import flops as jf
from afesp_tpu_torch import flops as tf

SIZES = [(1, 1), (2, 6), (5, 48), (10, 106), (15, 159), (20, 212), (37, 401)]
PRECISIONS = ["f64", "hybrid", "pallas", "fused"]
SPECS = ["mf,mafe->ae", "mnaf,mnfe->ae", "ne,nmie->mi", "mnef,ijef->mnij",
         "miea,mbej->ijab", "ijae,be->ijab", "ie,ejab->ijab", "mnij,mnab->ijab",
         "ijef,maef->ijma", "ia,jb->ijab", "mbef,jf->mbej"]


def test_sz_fraction_matches_jax():
    for spec in SPECS:
        assert tf.sz_fraction(spec) == jf.sz_fraction(spec), spec


@pytest.mark.parametrize("precision", PRECISIONS)
def test_spinorb_ccsd_iteration_flops_match_jax(precision):
    for o, v in SIZES:
        assert (tf.spinorb_ccsd_iteration_flops(o, v, precision)
                == jf.spinorb_ccsd_iteration_flops(o, v, precision)), (o, v)
    # the digit route counts 15 pair products per contraction: more work
    assert (tf.spinorb_ccsd_iteration_flops(20, 212, precision)
            > tf.spinorb_ccsd_iteration_flops(20, 212, "f64")) == (precision != "f64")


@pytest.mark.parametrize("strict", [False, True])
def test_spinorb_triples_flops_match_jax(strict):
    for o, v in SIZES:
        assert tf.spinorb_triples_flops(o, v, strict) == jf.spinorb_triples_flops(o, v, strict)


def test_ao_to_mo_and_digit_pairs_match_jax():
    for n in (1, 24, 58, 116, 174):
        assert tf.ao_to_mo_flops(n) == jf.ao_to_mo_flops(n)
    for L, maxdeg in itertools.product(range(1, 9), range(2, 11)):
        assert tf.digit_pairs(L, maxdeg) == jf.digit_pairs(L, maxdeg), (L, maxdeg)
    assert tf.digit_pairs(L=6) == 21 and tf.digit_pairs(5, 6) == 15


@pytest.mark.parametrize("doing_CR,strict", list(itertools.product([False, True], repeat=2)))
def test_spatial_flops_match_jax(doing_CR, strict):
    for o, v in SIZES:
        assert tf.spatial_ccsd_iteration_flops(o, v) == jf.spatial_ccsd_iteration_flops(o, v)
        # the port's "f64" count: the same contractions, once each
        assert tf.spatial_ccsd_iteration_flops(o, v, "f64") == 2.0 * (
            o * o * v**4 + 6.0 * o**3 * v**3 + 2.0 * o**2 * v**3 + 2.0 * o**4 * v * v)
        assert (tf.spatial_triples_flops(o, v, doing_CR, strict)
                == jf.spatial_triples_flops(o, v, doing_CR, strict)), (o, v)
