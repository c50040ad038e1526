"""Port parity: the port's own copy of the GAMESS deck writer and output
scraper (afesp_tpu_torch/utils/gamess.py) against tests/test_gamess.py's
three checks and against the JAX package's functions on the same inputs.
No GAMESS binary is needed: the scraper reads the archived output that
tests/test_gamess.py reads."""

from pathlib import Path

import numpy as np
import pytest

from afesp_tpu.utils import gamess as jgamess
from afesp_tpu_torch.utils import gamess

FIXTURE = Path(__file__).parent / "fixtures" / "gamess_crcc.out"
EXPECTED = np.array([
    -198.7017590776,  # REFERENCE
    -199.0531786921,  # MBPT(2)
    -199.0662953019,  # CCSD
    -199.0873411267,  # CCSD[T]
    -199.0859454726,  # CCSD(T)
    -199.0837170825,  # R-CCSD[T]
    -199.0824806241,  # R-CCSD(T)
    -199.0823582434,  # CR-CCSD[T]
    -199.0812536836,  # CR-CCSD(T)
    0.01376109,  # T1 diagnostic
    1.06641438,  # R-CCSD[T] denominator D[T]
    1.06641438,  # R-CCSD(T) denominator D(T)
])


def test_scrape_archived_output():
    vec = gamess.scrape_output(FIXTURE.read_text().splitlines())
    np.testing.assert_allclose(vec, EXPECTED, rtol=0, atol=0)


def test_scrape_all_slots_filled():
    vec = gamess.scrape_output(FIXTURE.read_text().splitlines())
    assert np.all(vec != 0.0)


def test_generate_input_deck(tmp_path):
    path = gamess.generate_input(1.75, tmp_path, "f2_1.750", "accd", symbol="F")
    text = path.read_text()
    assert "cctyp=cr-cc" in text
    assert "$basis  accd $end" in text
    assert "F 1 1.75" in text
    assert text.count("$end") == 6  # 5 groups + $data terminator


@pytest.mark.parametrize("bl,symbol,group,basis", [(1.75, "F", "dnh 2", "accd"),
                                                   (1.0977, "N", "dnh 4", "ccd")])
def test_matches_jax_functions(tmp_path, bl, symbol, group, basis):
    """The deck text and the scraped vector equal the JAX package's on
    the same inputs, and the scrape table is the same."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = gamess.generate_input(bl, tmp_path / "port", "x", basis, symbol=symbol, group=group)
    want = jgamess.generate_input(bl, tmp_path / "jax", "x", basis, symbol=symbol,
                                  group=group)
    assert got.name == want.name and got.read_text() == want.read_text()
    lines = FIXTURE.read_text().splitlines()
    assert np.array_equal(gamess.scrape_output(lines), jgamess.scrape_output(lines))
    assert gamess.SCRAPE == jgamess.SCRAPE


def test_run_gamess_drives_the_binary(tmp_path):
    """run_gamess writes the deck, runs the given command in the
    directory, keeps its output as <name>.out and scrapes it: a stand-in
    command that prints the archived output takes GAMESS's place."""
    fake = tmp_path / "fake_gamess"
    fake.write_text(f"#!/bin/sh\ncat {FIXTURE}\n")
    fake.chmod(0o755)
    vec = gamess.run_gamess(1.75, str(fake), tmp_path, "f2", "accd")
    np.testing.assert_allclose(vec, EXPECTED, rtol=0, atol=0)
    assert (tmp_path / "f2.inp").exists()
    assert (tmp_path / "f2.out").read_text().splitlines()[:5] == \
        FIXTURE.read_text().splitlines()[:5]
