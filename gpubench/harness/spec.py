"""What a cell is made of, found by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration (an entry of
`configs`, whose `file` is a JSON file of the molecule, basis, sizes
and the committed `els.in`) and a traffic mix (`<bench>/traffic/<name>.json`:
calc_type, ccsd_precision, the displacement, the fixed set of geometries
every run cycles through (`geometry_draws`), the loop, the environment
it sets and the reference module that judges it).  Its correctness
limits are `<bench>/limits/<cell>.json`, its per-layer metrics
`<bench>/metrics/<metric>.py`.  Adding a cell adds files and entries;
no file here names one.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

BENCH_DIR = "gpubench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list
    bench: Path  # the benchmark's folder

    def els_in(self, **override: str) -> str:
        """The configuration's els.in with the traffic's calc_type and
        ccsd_precision (or those of `override`), and every restart and
        output key off."""
        text = self.config["els_in"]
        mix = {k: self.traffic[k] for k in ("calc_type", "ccsd_precision")} | override
        keys = {k: f'"{v}"' for k, v in mix.items()}
        for key in ("write_fcidump", "scf_read_guess", "scf_write_guess",
                    "ccsd_read_amplitudes", "ccsd_write_amplitudes"):
            keys[key] = ".false."
        for key, value in keys.items():
            pat = re.compile(rf"^(\s*{key}\s*=\s*)[^,\n]*", re.M | re.I)
            if pat.search(text):
                text = pat.sub(lambda m: m.group(1) + value, text)
            else:  # before the namelist's closing "/", its last one
                end = text.rindex("/")
                text = text[:end] + f"{key} = {value},\n" + text[end:]
        return text

    def settings(self) -> dict:
        """The namelist values the reference needs, read from `els_in()`."""
        return parse_namelist(self.els_in())


def parse_namelist(text: str) -> dict:
    """key = value pairs of an `&elsinput ... /` namelist: strings,
    logicals, integers and reals (d or e exponents)."""
    out = {}
    for line in text.split("\n"):
        line = line.split("!")[0]
        for key, raw in re.findall(r"([A-Za-z_]\w*)\s*=\s*([^,\n]+)", line):
            raw = raw.strip()
            if raw[:1] in "\"'":
                val: object = raw.strip("\"'")
            elif raw.lower() in (".true.", ".false."):
                val = raw.lower() == ".true."
            else:
                num = raw.lower().replace("d", "e")
                val = float(num) if any(c in num for c in ".e") else int(num)
            out[key.lower()] = val
    return out


def _select(entries: list, cell: str) -> list:
    """Metric entries that apply to the cell: those whose `workloads`
    list it, or, with no such key, all."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_cell(root: Path, name: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bdir = root / BENCH_DIR
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((bdir / "traffic" / f"{w['traffic']}.json").read_text())
    if traffic.get("loop") != {"kind": "closed", "clients": 1}:
        raise ValueError(f"traffic {w['traffic']!r}: the harness runs one client in a closed "
                         f"loop, not {traffic.get('loop')}")
    draws = traffic.get("geometry_draws")
    if not draws or len(set(draws)) != len(draws):
        raise ValueError(f"traffic {w['traffic']!r}: geometry_draws has to list distinct "
                         f"displacement draws, not {draws}")
    limits = json.loads((bdir / "limits" / f"{name}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=_select(bench["end_to_end"], name),
                per_layer=_select(bench["per_layer"], name), bench=bdir)
