"""Multi-device CCSD: the vvvv contraction split over the mesh.

Port of `afesp_tpu/parallel/ccsd_shard.py` (`_fitting_mesh` :84-96,
`ccsd_solve_sharded` :97-121, `_pad_chunk_axis` and `shard_vvvv_limbs`
:124-153, `ccsd_solve_sharded_ext` :155-181, `ccsd_iteration_sharded`
:201-205).  JAX places the CCSD operands with shardings and lets GSPMD
partition the whole solve.  What shards here is the one O(o^2 v^4)
contraction, tau (or c_oovv) against vvvv, whose vvvv is the only O(v^4)
operand: each mesh entry holds its slice of that operand on its device
and computes its part of the term; the parts are gathered to the first
entry, where the rest of the iteration, DIIS included, runs as on one
device.  The operand splits by route:

  dense f64 and digit GEMM ("hybrid") — along a virtual index the
      product does not contract (the output's a), so every output
      element is computed as on one device: on the digit route the
      per-row (per-column) scales and digits of a slice are those rows
      of the whole, and its pair products are exact integers;
  the streaming tier's limbs — along their K-chunk axis, padded with
      zero chunks (scale 1) to a multiple of the mesh size, as in JAX;
      each entry's partial sum over its chunks is added on the first
      entry in chunk order.

The rules are JAX's: the solve uses the largest leading sub-mesh whose
size divides nvirt (`_fitting_mesh`; none below two entries, and then
the solve runs on one device), while the limbs shard over the full
mesh.  The stream tier's CR term reads the same sharded limbs
(`LimbShards.gemm`, through `ccsd_spatial._cr_vvvv_term_from_B`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..ops.cc_step import make_cc_solver
from ..ops.exact_gemm import digitize_A, exact_einsum, exact_gemm, prechunk_B, prechunk_op
from .mesh import Mesh

es = torch.einsum
# the dominant contraction of the spatial iteration, and its digit depth
# (ccsd_spatial._DIG_CONST_SPECS, L=6)
_SPATIAL_SPEC = "efab,ijef->ijab"
_SPATIAL_L = 6


def _fitting_mesh(mesh: Mesh, nvirt: int) -> Mesh | None:
    """The largest leading sub-mesh whose size divides nvirt (7 of 8
    entries for N2's nvirt=21); None below two entries."""
    size = mesh.size
    d = max(k for k in range(1, size + 1) if nvirt % k == 0)
    if d < 2:
        return None
    if d == size:
        return mesh
    return Mesh(mesh.devices[:d], mesh.axis_name)


def _ranges(n: int, parts: int) -> list[tuple[int, int]]:
    """`parts` contiguous ranges covering [0, n), the first n % parts one
    longer (torch.tensor_split's split)."""
    q, r = divmod(n, parts)
    bounds = [0]
    for p in range(parts):
        bounds.append(bounds[-1] + q + (p < r))
    return list(zip(bounds[:-1], bounds[1:]))


@dataclasses.dataclass
class VvvvShards:
    """The vvvv operand of a CCSD solve, split along the output's a over
    `mesh`: entry s holds a[lo_s:hi_s] of it on its device.  Called with
    X (c_oovv of the spatial iteration, tau of the spin-orbital one) on
    the first entry's device, it returns what the iteration's vvvv site
    computed from the whole operand: the spatial sum_ef v[e,f,a,b]
    X[i,j,e,f], or the spin-orbital 0.5 tau.vvvv assembled from its
    three spin blocks (`ccsd_spinorb._spin_blocks_out`).

    route: "dense" (f64 einsum) or "digits" (exact digit GEMM against
    the slice's digitized form, as the hybrid iteration's prechunked
    constant); spin: whether the parts are spin blocks (aa, bb, ab)."""

    mesh: Mesh
    route: str
    spin: bool
    parts: list
    nv: int  # spatial nvirt, or the spin-block width vs

    def _part(self, part, X, lo: int, hi: int):
        nv, na = self.nv, hi - lo
        if not self.spin:
            if self.route == "dense":
                return es(_SPATIAL_SPEC, part, X)
            return exact_einsum(_SPATIAL_SPEC, None, X, A_pre=part, A_shape=(nv, nv, na, nv),
                                maxdeg=7)
        vs = nv
        A, B = slice(0, vs), slice(vs, None)
        taus = (X[:, :, A, A], X[:, :, B, B], X[:, :, A, B])
        if self.route == "dense":
            return tuple(es("ijef,efab->ijab", t, blk) for t, blk in zip(taus, part))
        o = X.shape[0]
        return tuple(exact_gemm(A=t.reshape(o * o, vs * vs), B_pre=pre, maxdeg=6)
                     .reshape(o, o, na, vs) for t, pre in zip(taus, part))

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        first = X.device
        spans = _ranges(self.nv, self.mesh.size)
        outs = [self._part(p, X.to(d), lo, hi)
                for d, p, (lo, hi) in zip(self.mesh.devices, self.parts, spans)]
        if not self.spin:
            return torch.cat([o.to(first) for o in outs], dim=2)
        from ..methods.ccsd_spinorb import _spin_blocks_out

        aa, bb, ab = (torch.cat([o[k].to(first) for o in outs], dim=2) for k in range(3))
        return _spin_blocks_out(aa, bb, ab)


def vvvv_shards(mesh: Mesh, v, digits: bool) -> VvvvShards:
    """Split the vvvv operand of slices `v` (restricted `Slices` or
    `SpinSlices`, dense or as spin blocks) over `mesh`, digitized per
    slice on the digit route (L=6 spatial as its A side, L=5 spin
    blocks as their B side, the one-device iteration's depths)."""
    route = "digits" if digits else "dense"
    if hasattr(v, "v_vvvv"):
        vvvv = v.v_vvvv
        nv = vvvv.shape[0]
        parts = []
        for d, (lo, hi) in zip(mesh.devices, _ranges(nv, mesh.size)):
            part = vvvv[:, :, lo:hi, :].to(d).contiguous()
            parts.append(prechunk_op(_SPATIAL_SPEC, "A", part, L=_SPATIAL_L) if digits else part)
        return VvvvShards(mesh, route, False, parts, nv)
    if v.vvvv_blocks is not None:
        aa, ab = v.vvvv_blocks
        blocks = (aa, aa, ab)  # bb reads aa for closed shells in block spin order
    else:
        nv = v.vvvv.shape[0]
        if nv % 2:
            raise ValueError(f"spin-orbital vvvv of odd width {nv}: no spin blocks to split")
        vs2 = nv // 2
        A, B = slice(0, vs2), slice(vs2, None)
        blocks = (v.vvvv[A, A, A, A], v.vvvv[B, B, B, B], v.vvvv[A, B, A, B])
    vs = blocks[0].shape[0]
    parts = []
    for d, (lo, hi) in zip(mesh.devices, _ranges(vs, mesh.size)):
        held = {}  # one slice for a block read twice (aa as bb)
        for blk in blocks:
            if id(blk) not in held:
                part = blk[:, :, lo:hi, :].to(d).contiguous()
                held[id(blk)] = prechunk_B(part.reshape(vs * vs, -1), L=5) if digits else part
        parts.append(tuple(held[id(blk)] for blk in blocks))
    return VvvvShards(mesh, route, True, parts, vs)


@dataclasses.dataclass
class LimbShards:
    """The streaming tier's digit-limb v_vvvv (`prechunk_B_chunkscaled`
    output) padded to a multiple of the mesh size in K chunks and split
    along them: entry s holds its contiguous run of chunks (limbs and
    scales), on its device, in storage of its own."""

    mesh: Mesh
    parts: list  # per entry: (limb list, scales)
    nc: int  # chunks after padding
    nv: int

    def nbytes(self) -> list[int]:
        """Bytes each entry holds (limbs and scales)."""
        return [sum(c.numel() * c.element_size() for c in chunks) + s.numel() * s.element_size()
                for chunks, s in self.parts]

    def gemm(self, A: torch.Tensor, maxdeg: int) -> torch.Tensor:
        """A (M, K) @ the limbs (K, N) on A's device.  A is digitized once
        (as on one device: its row scales over the whole K), its digit
        columns zero-padded to the padded chunks, and each entry takes
        the columns of its chunks: its digit GEMM over them is its
        partial, and the partials are added in chunk order."""
        chunks0 = self.parts[0][0]
        kc, per = chunks0[0].shape[1], chunks0[0].shape[0]
        Ad, sA = digitize_A(A, len(chunks0))
        pad = self.nc * kc - A.shape[1]
        Ad = [torch.nn.functional.pad(d, (0, pad)) for d in Ad]
        out = None
        for k, (d, part) in enumerate(zip(self.mesh.devices, self.parts)):
            cols = slice(k * per * kc, (k + 1) * per * kc)
            A_pre = ([x[:, cols].to(d) for x in Ad], sA.to(d))
            p = exact_gemm(A_pre=A_pre, B_pre=part, maxdeg=maxdeg).to(A.device)
            out = p if out is None else out + p
        return out

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        """sum_ef X[i,j,e,f] v[e,f,a,b], the spatial iteration's vvvv
        term against the limbs (its maxdeg=7 digit GEMM)."""
        o, nv = X.shape[0], self.nv
        return self.gemm(X.reshape(o * o, nv * nv), maxdeg=7).reshape(o, o, nv, nv)


def _pad_chunk_axis(vvvv_B, mult: int):
    """Pad the limbs' chunk axis to a multiple of `mult` with all-zero
    chunks of scale 1: zero digits add exactly zero to every pair
    product, so a prime chunk count (53 at nvirt=106 and 159) shards
    evenly over any mesh."""
    chunks, s = vvvv_B
    pad = (-chunks[0].shape[0]) % mult
    if pad == 0:
        return vvvv_B
    chunks = [torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad)) for c in chunks]
    s = torch.cat([s, s.new_ones((pad,) + tuple(s.shape[1:]))])
    return chunks, s


def shard_vvvv_limbs(mesh: Mesh, vvvv_B) -> LimbShards:
    """Pad and chunk-split the limbs over `mesh`.  Idempotent, as JAX's:
    limbs already split over `mesh` come back as they are, so the solve
    and the CR term read one sharded copy."""
    if isinstance(vvvv_B, LimbShards):
        if vvvv_B.mesh != mesh:
            raise ValueError("the limbs are split over another mesh")
        return vvvv_B
    chunks, s = _pad_chunk_axis(vvvv_B, mesh.size)
    nc = chunks[0].shape[0]
    per = nc // mesh.size
    parts = [([c[k * per:(k + 1) * per].to(d, copy=True) for c in chunks],
              s[k * per:(k + 1) * per].to(d, copy=True))
             for k, d in enumerate(mesh.devices)]
    return LimbShards(mesh, parts, nc, round(chunks[0].shape[2] ** 0.5))


def _without_vvvv(v):
    """`v` with its vvvv operand taken out, for a solver's precompute
    hook, which then digitizes every constant but vvvv."""
    if hasattr(v, "v_vvvv"):
        return dataclasses.replace(v, v_vvvv=None)
    return dataclasses.replace(v, vvvv=None, vvvv_blocks=None)


def _sharded_solver(solver, shards_of: Callable, with_pre: bool = False):
    """`solver` (a make_cc_solver or make_cc_solver_pre solve) as one
    whose iteration reads its vvvv term from the shards `shards_of(v)`,
    built once per solve with the solver's other constants."""
    iteration, energy, precompute = solver.parts

    def consts(v):
        base = None
        if precompute is not None:
            base = precompute(_without_vvvv(v), None) if with_pre else precompute(_without_vvvv(v))
        return base, shards_of(v)

    def step(t1, t2, v, D_ia, D_ijab, c):
        return iteration(t1, t2, v, D_ia, D_ijab, c[0], vvvv_shards=c[1])

    return make_cc_solver(step, energy, consts)


def _digits(solver) -> bool:
    """Whether the solver runs the digit-GEMM iteration (its
    `_iteration_core`'s vvvv_split)."""
    return bool(solver.parts.iteration_fn.keywords.get("vvvv_split", False))


def ccsd_solve_sharded(mesh: Mesh, solver, state, v, D_ia, D_ijab, oovv, e0: float,
                       e_tol: float, t_tol: float, *, nerr: int, maxiter: int,
                       on_iteration=None):
    """`solver` (`get_spatial_solver` / `get_spinorb_solver`) with its
    vvvv term split over the sub-mesh that fits nvirt; on one device
    when none fits.  Returns the solver's (state, energies, converged)."""
    loop = dict(nerr=nerr, maxiter=maxiter, on_iteration=on_iteration)
    sub = _fitting_mesh(mesh, state.t2.shape[3])
    if sub is None:
        return solver(state, v, D_ia, D_ijab, oovv, e0, e_tol, t_tol, **loop)
    digits = _digits(solver)
    solve = _sharded_solver(solver, lambda v: vvvv_shards(sub, v, digits))
    return solve(state, v, D_ia, D_ijab, oovv, e0, e_tol, t_tol, **loop)


def ccsd_solve_sharded_ext(mesh: Mesh, solver, state, v, D_ia, D_ijab, oovv, e0: float,
                           e_tol: float, t_tol: float, vvvv_B, *, nerr: int, maxiter: int,
                           on_iteration=None):
    """The streaming tier's solve (`ccsd_spatial_solver_ext`) with its
    digit-limb v_vvvv chunk-split over the full mesh: each entry holds
    1/n of the padded limbs."""
    limbs = shard_vvvv_limbs(mesh, vvvv_B)
    solve = _sharded_solver(solver, lambda v: limbs, with_pre=True)
    return solve(state, v, D_ia, D_ijab, oovv, e0, e_tol, t_tol, nerr=nerr, maxiter=maxiter,
                 on_iteration=on_iteration)


def ccsd_iteration_sharded(mesh: Mesh, t1, t2, v, D_ia, D_ijab):
    """One f64 spin-orbital CCSD iteration (the reference's equations)
    with its vvvv term split over the sub-mesh that fits nvirt."""
    from ..methods.ccsd_spinorb import _iteration_core

    sub = _fitting_mesh(mesh, t2.shape[3])
    shards = None if sub is None else vvvv_shards(sub, v, digits=False)
    return _iteration_core(t1, t2, v, D_ia, D_ijab, None, paper_foo=False, vvvv_shards=shards)
