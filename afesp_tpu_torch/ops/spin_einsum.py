"""Spin-block-sparse einsum for spin-orbital tensors in BLOCK spin layout.

Port of `afesp_tpu/ops/spin_einsum.py`.  Every tensor in the
spin-orbital CC algebra conserves Sz blockwise (ops/spin.py builds the
ERI slices that way, and the CC iterates inherit it exactly: forbidden
blocks are exact zeros, since every contribution to them contains an
exactly-zero factor):

  * 2-index (t1, F):    block (s0, s1) nonzero iff s0 == s1
  * 4-index (v, t2, W): block (s0, s1, s2, s3) nonzero iff s0+s1 == s2+s3

`spin_blocked_einsum` enumerates the spin assignments of all indices in
an einsum spec, drops every assignment that hits a zero block of any
operand, contracts the surviving half-size blocks with `torch.einsum`,
and reassembles the output with `torch.cat`.  A typical two-operand
o^3 v^3 contraction becomes 10 GEMMs, each 1/64 of the dense size:
exact up to f64 reassociation.  Plain torch, as in the JAX package.
"""

from __future__ import annotations

import itertools

import torch


def _rule(sigmas: tuple[int, ...]) -> bool:
    if len(sigmas) == 2:
        return sigmas[0] == sigmas[1]
    if len(sigmas) == 4:
        return sigmas[0] + sigmas[1] == sigmas[2] + sigmas[3]
    raise ValueError(f"no spin rule for a {len(sigmas)}-index tensor")


def spin_blocked_einsum(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """einsum over block-spin-layout operands, skipping zero spin blocks.

    All operands must be 2- or 4-index tensors obeying the Sz rule above,
    with every axis of even length (alpha half then beta half).
    """
    ins, out = spec.replace(" ", "").split("->")
    in_specs = ins.split(",")
    letters = sorted(set("".join(in_specs) + out))

    # full extent of each index letter
    dims: dict[str, int] = {}
    for op, sp in zip(ops, in_specs):
        for ax, c in enumerate(sp):
            dims[c] = op.shape[ax]

    def half(c: str, s: int) -> slice:
        h = dims[c] // 2
        return slice(0, h) if s == 0 else slice(h, dims[c])

    pieces: dict[tuple[int, ...], torch.Tensor] = {}
    for assign in itertools.product((0, 1), repeat=len(letters)):
        s = dict(zip(letters, assign))
        if not all(_rule(tuple(s[c] for c in sp)) for sp in in_specs):
            continue
        sliced = [op[tuple(half(c, s[c]) for c in sp)] for op, sp in zip(ops, in_specs)]
        key = tuple(s[c] for c in out)
        term = torch.einsum(spec, *sliced)
        pieces[key] = term if key not in pieces else pieces[key] + term

    block_shape = tuple(dims[c] // 2 for c in out)

    def assemble(prefix: tuple[int, ...]) -> torch.Tensor:
        if len(prefix) == len(out):
            p = pieces.get(prefix)
            if p is None:
                return ops[0].new_zeros(block_shape)
            return p
        axis = len(prefix)
        return torch.cat([assemble(prefix + (0,)), assemble(prefix + (1,))], dim=axis)

    result = assemble(())
    # the recursive closure refers to itself through its cell: empty the
    # cell, or the cycle keeps the operands and blocks alive (device
    # memory included) until the garbage collector runs
    del assemble
    return result
