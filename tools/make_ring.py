"""Cyclic water clusters (H2O)n by the ring rule of `make_trimer.py`,
for any n >= 3: prints the `coords_bohr` of a benchmark configuration
(`gpubench/configs/`) as JSON, one [x, y, z] in bohr an atom, in the
order O, donated H, free H of each water.

    python3 tools/make_ring.py 5 [--oo 5.14] [--oh 1.81]

The oxygens sit on a regular n-gon of side `--oo` in the xy plane; each
water donates one H-bond to the next oxygen around the ring (its donated
H on the O-O line, `--oh` from its O); each free H points out of the
plane, tilted away from the ring's centre as in the trimer, up and down
in turn around the ring.  For odd n the last and the first water both
point up: the one frustrated pair a ring of odd n cannot avoid.  These
are a rule's coordinates, not a published geometry's.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def ring_coords(n: int, oo: float = 5.14, oh: float = 1.81) -> np.ndarray:
    """(3n, 3) bohr: O, donated H, free H of each of n waters."""
    r_ring = oo / (2.0 * np.sin(np.pi / n))  # circumradius of the O n-gon
    ox = [np.array([r_ring * np.cos(2.0 * np.pi * m / n),
                    r_ring * np.sin(2.0 * np.pi * m / n), 0.0]) for m in range(n)]
    coords = []
    for m in range(n):
        o, on = ox[m], ox[(m + 1) % n]
        u = (on - o) / np.linalg.norm(on - o)
        up = 1.0 if m % 2 == 0 else -1.0
        out = o / np.linalg.norm(o)
        hf = o + oh * (0.40 * out + up * 0.917 * np.array([0.0, 0.0, 1.0]))
        coords += [o, o + oh * u, hf]
    return np.array(coords)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int)
    p.add_argument("--oo", type=float, default=5.14, help="O-O distance, bohr")
    p.add_argument("--oh", type=float, default=1.81, help="O-H distance, bohr")
    args = p.parse_args(argv)
    print(json.dumps([[float(x) for x in row] for row in ring_coords(args.n, args.oo, args.oh)]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
