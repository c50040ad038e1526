"""f64-grade GEMM from small-integer digit products (Ozaki scheme).

Port of `afesp_tpu/ops/exact_gemm.py`, the whole module.  Operands are
scaled by power-of-two row/column scales into [-1/2, 1/2], expanded in
base-128 integer digits, and every digit pair (i, j) with
(i+1)+(j+1) <= maxdeg is multiplied as an integer GEMM.  Digit products
(<= 72^2 < 2^14) summed over K <= 131072 are exact in int32, and over a
512-wide chunk exact in f32; the only errors are the dropped high-degree
pairs, the f32 digitize seam (~2^-48 of scale, see `_digits`) and the
final f64 recombination.

How the port computes a digit-pair product ("route"):
  * "int8" (the default on every device): `torch._int_mm`, int8 x int8 ->
    int32 over the whole K (exact while K <= _MAX_K).  On the H100 this
    is cuBLASLt on the integer tensor cores; on the CPU it runs too.
  * "f32": `torch.matmul` over the f32 digit planes, chunked at kc = 512
    as the JAX package does, each chunk exact in the f32 accumulator and
    the chunks summed in f64.  Exact only without TF32, which is asserted.
Both give the exact integer sum, so a group of same-degree pairs is the
same f64 number on either route and on either device: on the flat-scale
routes the result is bit for bit the JAX package's, whose f32 group sums
and f64 chunk reduction are exact as well (`_recombine`).  A route that
cannot launch raises; nothing falls back to an f64 product.

Digits are stored as int8 tensors, one per limb, unchunked: `prechunk_A`
and `prechunk_B` digitize once (1 byte per element and limb where the
JAX package holds 2-byte bf16 chunks); the f32 route chunks at use.
`prechunk_B_chunkscaled` keeps its per-chunk layout (nc, kc, N), because
its scales are per chunk.

Each outermost call of an entry point (`exact_gemm`, `exact_einsum`,
`gemm_B_pre_streamed`) is the span `digit_gemm` (`trace.py`);
`digit_pair_gemm.launches` counts the digit pairs and
`_int_mm.launches` the int8 GEMMs they take after the K and tile
splits.

A CC solve repeats the same contractions every iteration, each a few
hundred small launches that the host issues one by one.  Inside a graph
scope (`graph_scope()`, which `cc_step.make_cc_solver`'s solve opens
around its loop) an outermost entry call is replayed from a CUDA graph
when all three hold: a scope is open; every tensor it is given (operand,
prechunked or pre-digitized) lies on the current card; and its key has
been met before in the scope.  The key is the entry, its non-tensor
arguments, the identity of the tensors of each A_pre/B_pre/A_dig/B_dig
and the shape and dtype of each tensor operand (`_call_key`).  The first
meeting runs eagerly; the second captures the entry's unchanged body on
a side stream, reading static copies of the varying operands, into a
pool the scope's graphs share, and replays it; later meetings copy
their operands in, replay, and hand back a clone of the static output.
A replay runs the same kernels on the same bytes, so its result is the
eager call's bit for bit.  Closing the scope drops every graph, buffer
and pool, and cuBLAS's per-stream workspaces, so the capture stream's
holds no memory past the solve.  Outside a scope, on the CPU and where
an operand lies on another card (the mesh's parts), calls run eagerly as
they always did.

Counters: `graph_scope.calls` (`digit_graph.calls`, outermost calls in a
scope on a card), `.captures`, `.replays` (calls served by replaying an
existing graph); a replay adds what its capture added to
`_int_mm.launches` and `digit_pair_gemm.launches`, which so count what
the device runs.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import math
import weakref

import torch

from .. import trace
from ..device import F64, current

F32 = torch.float32

# base-2^7 digits: |digit| <= 72 fits int8, digit products <= 2^14, and
# int32 accumulation over K products stays exact while K*2^14 < 2^31
_Q = 7
_BASE = float(2**_Q)
_MAX_K = 2**31 // (2 ** (2 * _Q + 2))  # 131072, with 2 bits of slack

# f32 digit GEMMs accumulate exactly while kc * 2^(2Q) < 2^24; larger K
# is chunked to kc with f64 combination across chunks (still exact)
_MAX_K_F32 = 2**24 // (2 ** (2 * _Q + 1))  # 512, with 1 bit of slack

ROUTES = ("int8", "f32")


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e in f32 for int32 exponents e in [-149, 128], built from the
    f64 exponent field (exact on every device, unlike a pow call):
    jnp.ldexp(f32(1), e) of the JAX package, inf at e = 128 included."""
    return ((e.to(torch.int64) + 1023) << 52).view(F64).to(F32)


def _pow2_scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-row/col power-of-two scale s >= max|x| (exact divides), as
    the JAX package computes it: the exponent of an f32 frexp, with an
    exact power-of-two shift ladder bringing any f64 magnitude into
    f32's normal range first, and one halving test for the exact
    ceiling (f32 rounding cannot take a value below a power of two it
    equals or exceeds, so 2^e >= m always)."""
    m = x.abs().amax(dim=dim, keepdim=True)
    m = torch.where(m > 0, m, torch.ones_like(m))
    if m.dtype == F64:
        f = torch.ones_like(m)
        one = torch.ones((), dtype=F64, device=m.device)
        for t in (100.0, 300.0, 500.0, 700.0, 900.0):
            f = f * torch.where(m > 2.0**t, one * 2.0**-200, one)
            f = f * torch.where(m < 2.0**-t, one * 2.0**200, one)
        _, e = torch.frexp((m * f).to(F32))
        s = _pow2(e).to(F64) / f
    else:
        _, e = torch.frexp(m.to(F32))
        s = _pow2(e).to(m.dtype)
    return torch.where(0.5 * s >= m, 0.5 * s, s)


def _digits(x: torch.Tensor, L: int) -> list[torch.Tensor]:
    """x in [-1/2, 1/2] -> L base-128 int8 digit tensors (balanced round,
    half to even).  An exact f32 cascade seeded by the hi/lo split of
    the f64 input: y*128, round and subtract are exact at every step.
    The one rounding seam is folding the low f32 half into the level-3
    residual (~2^-48 of scale); the fold can push level-4+ inputs
    slightly past 1/2, so digits are bounded by 72, not 64."""
    is64 = x.dtype == F64
    xh = x.to(F32) if is64 else x
    y = xh
    ds = []
    for i in range(L):
        if i == 3 and is64:
            # fold in the low half, scaled to the cascade's level
            xl = (x - xh.to(x.dtype)).to(F32)
            y = y + xl * _BASE**3
        y = y * _BASE
        d = torch.round(y)
        y = y - d
        ds.append(d.to(torch.int8))
    return ds


def digitize_A(A: torch.Tensor, L: int = 7):
    """(M,K) f64 -> (digit list, row scale (M,1)) for exact_gemm."""
    s = _pow2_scale(A, 1)
    return _digits(A / (2.0 * s), L), s


def digitize_B(B: torch.Tensor, L: int = 7):
    """(K,N) f64 -> (digit list, col scale (1,N)) for exact_gemm."""
    s = _pow2_scale(B, 0)
    return _digits(B / (2.0 * s), L), s


def _chunk_geometry(K: int) -> tuple[int, int, int]:
    kc = min(K, _MAX_K_F32)
    nc = -(-K // kc)
    return kc, nc, nc * kc - K


def _check_f32_exact(t: torch.Tensor) -> None:
    """The f32 route and split_matmul need IEEE f32 products: TF32's
    10-bit mantissa would round the digit sums (and void the hi/lo
    split) without a sound."""
    if t.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "f32 matmul runs TF32 on this device (allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}, precision="
            f"{torch.get_float32_matmul_precision()!r}); the digit GEMM's f32 "
            "route needs IEEE f32"
        )


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    r, c = t.shape
    if (r, c) == (rows, cols):
        return t.contiguous()
    return torch.nn.functional.pad(t, (0, cols - c, 0, rows - r))


# the widest block of rows or columns one torch._int_mm call takes:
# cuBLASLt's int8 kernels refuse an output 112360 columns wide
_INT_MM_TILE = 32768


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M,K) int8 @ b (K,N) int8 -> (M,N) int32, exact for K <= _MAX_K.
    Zero digits pad the operands to torch._int_mm's CUDA shape rules
    (M > 16, K and N multiples of 8; here M to 32 at least, K to a
    multiple of 16), b goes in column-major, the "TN" layout of
    cuBLASLt's int8 kernels, and an output wider or taller than
    _INT_MM_TILE is computed block by block.  The same code runs on
    every device, so the CPU exercises it.  Adds one to
    `_int_mm.launches` per `torch._int_mm` call."""
    M, K = a.shape
    N = b.shape[1]
    Kp = -(-K // 16) * 16
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    for m0 in range(0, M, _INT_MM_TILE):
        ab = a[m0:m0 + _INT_MM_TILE]
        Mp = max(32, -(-ab.shape[0] // 8) * 8)
        ap = _pad_to(ab, Mp, Kp)
        for n0 in range(0, N, _INT_MM_TILE):
            bb = b[:, n0:n0 + _INT_MM_TILE]
            Np = -(-bb.shape[1] // 8) * 8
            blk = torch._int_mm(ap, _pad_to(bb.t(), Np, Kp).t())
            _int_mm.launches += 1
            out[m0:m0 + ab.shape[0], n0:n0 + bb.shape[1]] = blk[:ab.shape[0], :bb.shape[1]]
    return out


def digit_pair_gemm(a: torch.Tensor, b: torch.Tensor, route: str = "int8") -> torch.Tensor:
    """The exact integer product of one digit pair, a (M,K) int8 @
    b (K,N) int8, as f64 (integers below 2^53: exact).  Adds one to
    `digit_pair_gemm.launches` per call."""
    K = a.shape[1]
    digit_pair_gemm.launches += 1
    if route == "int8":
        out = None
        with current(a.device):  # the card of a mesh entry, current
            for k0 in range(0, K, _MAX_K):
                p = _int_mm(a[:, k0:k0 + _MAX_K], b[k0:k0 + _MAX_K]).to(F64)
                out = p if out is None else out + p
        return out
    if route != "f32":
        raise ValueError(f"digit route {route!r}: one of {ROUTES}")
    _check_f32_exact(a)
    M, N = a.shape[0], b.shape[1]
    kc, nc, pad = _chunk_geometry(K)
    af = torch.nn.functional.pad(a.to(F32), (0, pad)).reshape(M, nc, kc).transpose(0, 1)
    bf = torch.nn.functional.pad(b.to(F32), (0, 0, 0, pad)).reshape(nc, kc, N)
    return torch.bmm(af, bf).to(F64).sum(0)  # exact per chunk, exact f64 sum


_int_mm.launches = 0
digit_pair_gemm.launches = 0
trace.register("_int_mm.launches", _int_mm)
trace.register("digit_pair_gemm.launches", digit_pair_gemm)


_scope: _GraphScope | None = None  # the open graph scope


@contextlib.contextmanager
def graph_scope():
    """The scope inside which repeated entry calls replay CUDA graphs
    (module docstring).  A scope opened inside an open one is the outer
    one's.  Closing drops the graphs, their buffers and their pool, on
    every exit."""
    global _scope
    if _scope is not None:
        yield
        return
    _scope = scope = _GraphScope()
    try:
        yield
    finally:
        _scope = None
        scope.close()


graph_scope.calls = graph_scope.captures = graph_scope.replays = 0
trace.register("digit_graph.calls", graph_scope, "calls")
trace.register("digit_graph.captures", graph_scope, "captures")
trace.register("digit_graph.replays", graph_scope, "replays")


def _tensors(x) -> list:
    """The tensors in x, a tensor or nested tuples and lists of them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return []


def _card_of(args, kwargs) -> int | None:
    """The current card's index if every tensor of the call lies on it."""
    ts = _tensors(args) + _tensors(list(kwargs.values()))
    if not ts or not all(t.is_cuda for t in ts):
        return None
    card = torch.cuda.current_device()
    return card if all(t.device.index == card for t in ts) else None


def _call_key(entry: str, arguments: dict):
    """(key, varying, held) of an entry call's bound arguments: the key
    names the entry, each non-tensor argument, the identity of the
    tensors of each A_pre/B_pre/A_dig/B_dig (`held`) and the shape and
    dtype of each tensor operand; `varying` names the operands the
    body reads (A and B, unless a prechunked or pre-digitized form of
    the same side stands in for it and the tensor gives its shape only)."""
    parts, varying, held = [entry], [], []
    for name, val in arguments.items():
        if name in ("A_pre", "B_pre", "A_dig", "B_dig") and val is not None:
            ts = _tensors(val)
            held += ts
            parts.append((name, tuple(map(id, ts))))
        elif isinstance(val, torch.Tensor):
            parts.append((name, tuple(val.shape), val.dtype))
            if arguments.get(name + "_pre") is None and arguments.get(name + "_dig") is None:
                varying.append(name)
        else:
            parts.append((name, val))
    return tuple(parts), varying, held


def _side_stream() -> torch.cuda.Stream:
    """A stream to capture on.  One int8 and one f32 GEMM run on it first,
    outside any capture, so that cuBLAS holds its handle and workspace
    for the stream before a capture needs them (a workspace made inside
    a capture would live in the graphs' pool for the process's life)."""
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        a = torch.zeros((32, 16), dtype=torch.int8, device=side.device)
        torch._int_mm(a, a[:8].t())
        f = torch.zeros((8, 8), dtype=F32, device=side.device)
        torch.mm(f, f)
    return side


def _launches() -> tuple[int, int]:
    return _int_mm.launches, digit_pair_gemm.launches


class _Graph:
    """One entry call captured: its static operand copies, its output,
    the launch counts its capture added, and the prechunked tensors it
    reads (held, so that their memory and ids stay its own)."""

    def __init__(self, fn, bound: inspect.BoundArguments, varying: list, held: list, pool,
                 side: torch.cuda.Stream):
        self.held = held
        self.inputs = {n: torch.empty_like(bound.arguments[n],
                                           memory_format=torch.contiguous_format)
                       for n in varying}
        static = inspect.BoundArguments(bound.signature, bound.arguments | self.inputs)
        before = _launches()
        self.graph = torch.cuda.CUDAGraph()
        here = torch.cuda.current_stream()
        side.wait_stream(here)
        with torch.cuda.stream(side):
            # thread_local: the compile-ahead thread (warmup.py) may query
            # the card meanwhile; this thread alone is held to capture's rules
            self.graph.capture_begin(pool, capture_error_mode="thread_local")
            try:
                self.output = fn(*static.args, **static.kwargs)
            finally:
                self.graph.capture_end()
        here.wait_stream(side)
        self.counts = [a - b for a, b in zip(_launches(), before)]

    def replay(self, arguments: dict) -> torch.Tensor:
        for name, static in self.inputs.items():
            static.copy_(arguments[name])
        self.graph.replay()
        return self.output.clone()


class _GraphScope:
    """An open scope's graphs by key, and the keys met once, each with
    weak references to its held tensors (a dead one means its id may
    belong to another tensor now: the key counts as not met); the
    graphs' shared memory pool and capture stream, made at the first
    capture."""

    def __init__(self):
        self.graphs: dict = {}
        self.met: dict = {}
        self.pool = self.side = None
        self.depth = 0  # entry-point calls open, the outermost included

    def close(self) -> None:
        """Drop the graphs and, where any was captured, cuBLAS's
        workspaces, the capture stream's among them (the next cuBLAS call
        on a stream makes its own anew), after the capture stream has
        been ordered behind the current one's work, the replays'."""
        self.graphs.clear()
        self.met.clear()
        if self.side is not None:
            self.side.wait_stream(torch.cuda.current_stream(self.side.device))
            torch._C._cuda_clearCublasWorkspaces()
        self.pool = self.side = None

    def call(self, fn, bound: inspect.BoundArguments, card: int):
        bound.apply_defaults()
        key, varying, held = _call_key(fn.__name__, bound.arguments)
        key = (card, key)
        graph_scope.calls += 1
        g = self.graphs.get(key)
        if g is not None:
            graph_scope.replays += 1
            _int_mm.launches += g.counts[0]
            digit_pair_gemm.launches += g.counts[1]
            return g.replay(bound.arguments)
        refs = self.met.pop(key, None)
        if refs is None or any(r() is None for r in refs):
            self.met[key] = [weakref.ref(t) for t in held]
            return fn(*bound.args, **bound.kwargs)
        if self.pool is None:
            self.pool, self.side = torch.cuda.graph_pool_handle(), _side_stream()
        g = self.graphs[key] = _Graph(fn, bound, varying, held, self.pool, self.side)
        graph_scope.captures += 1
        return g.replay(bound.arguments)


def _entry_point(entry):
    """A digit-GEMM entry point: the span `digit_gemm` around each call
    (one made inside another is the outer one's), and an outermost call
    inside a graph scope served by the scope (module docstring)."""
    signature = inspect.signature(entry)

    @functools.wraps(entry)
    def call(*args, **kwargs):
        with trace.span("digit_gemm"):
            scope = _scope
            if scope is None:
                return entry(*args, **kwargs)
            outermost = scope.depth == 0
            scope.depth += 1
            try:
                card = _card_of(args, kwargs) if outermost else None
                if card is None:
                    return entry(*args, **kwargs)
                return scope.call(entry, signature.bind(*args, **kwargs), card)
            finally:
                scope.depth -= 1
    return call


def prechunk_A(A: torch.Tensor, L: int = 4):
    """Digitize an (M,K) lhs once for repeated exact_gemm calls with a
    loop-constant operand (the ERI slices inside the CC loop): returns
    (int8 digit list, row scale) for A_pre."""
    Ad, sA = digitize_A(A, L)
    return [d.contiguous() for d in Ad], sA


def prechunk_op(spec: str, side: str, arr: torch.Tensor, L: int = 4):
    """Prechunk one side of an exact_einsum contraction: matricise `arr`
    exactly as exact_einsum would for `spec` (side "A" -> (fa+contr)
    rows, side "B" -> (contr+fb) columns) and digitize once."""
    ins, _ = spec.split("->")
    sa, sb = ins.split(",")
    contr = [c for c in sa if c in sb]
    if side == "A":
        fa = [c for c in sa if c not in contr]
        Ap = arr.permute([sa.index(c) for c in fa + contr])
        return prechunk_A(Ap.reshape(math.prod(Ap.shape[: len(fa)]), -1), L)
    fb = [c for c in sb if c not in contr]
    Bp = arr.permute([sb.index(c) for c in contr + fb])
    return prechunk_B(Bp.reshape(math.prod(Bp.shape[: len(contr)]), -1), L)


def prechunk_B(B: torch.Tensor, L: int = 4):
    """(K,N) rhs analogue of prechunk_A; returns B_pre."""
    Bd, sB = digitize_B(B, L)
    return [d.contiguous() for d in Bd], sB


def prechunk_B_chunkscaled(B: torch.Tensor, L: int = 5):
    """(K,N) rhs digitized with per-K-chunk column scales: chunk c of kc
    rows gets its own power-of-two scales s[c] >= max|chunk| per column,
    so each chunk digitizes on its own (a huge operand can be digitized
    blockwise) and truncation is ~2^-7L of the chunk max.

    Returns (chunks, sB): chunks[j] is (nc, kc, N) int8, sB is (nc, 1, N)
    f64.  kc is the largest divisor of K <= 512; K must have one >= 8."""
    K, N = B.shape
    kc = max(d for d in range(1, min(K, _MAX_K_F32) + 1) if K % d == 0)
    if kc < 8:
        raise ValueError(f"pathological K={K}: no usable divisor <= {_MAX_K_F32}")
    nc = K // kc
    limbs = [torch.empty((nc, kc, N), dtype=torch.int8, device=B.device) for _ in range(L)]
    s = torch.empty((nc, 1, N), dtype=B.dtype, device=B.device)
    for c in range(nc):
        rows = B[c * kc:(c + 1) * kc]
        sc = _pow2_scale(rows, 0)
        for j, d in enumerate(_digits(rows / (2.0 * sc), L)):
            limbs[j][c] = d
        s[c] = sc
    return limbs, s


def reconstruct_f32_from_B_pre(B_pre, K: int, N: int) -> torch.Tensor:
    """Recombine a prechunk_B_chunkscaled operand back to its f32 value
    (K, N), for consumers that want a plain f32 copy."""
    chunks, s = B_pre
    acc = None
    for j, ch in enumerate(chunks):
        term = ch.to(F32) * 2.0 ** (-_Q * (j + 1))
        acc = term if acc is None else acc + term
    out = acc * (2.0 * s).to(F32)
    return out.reshape(K, N)


@_entry_point
def gemm_B_pre_streamed(A: torch.Tensor, B_pre, maxdeg: int = 6) -> torch.Tensor:
    """(M,K) @ (K,N) against a prechunk_B_chunkscaled operand, one K chunk
    at a time: the transient is one (M,N) group of pair products and the
    f64 accumulator.  Per chunk the groups are exact; the chunks combine
    in f64 in chunk order, as the JAX package's fori_loop does."""
    Bc, sB = B_pre
    nc, kc, N = Bc[0].shape
    Ad, sA = digitize_A(A, len(Bc))
    acc = torch.zeros((A.shape[0], N), dtype=F64, device=A.device)
    for c in range(nc):
        groups: dict = {}
        for i in range(len(Ad)):
            a = Ad[i][:, c * kc:(c + 1) * kc]
            for j in range(len(Bc)):
                if i + j + 2 > maxdeg:
                    continue
                _group_add(groups, i + j + 2, digit_pair_gemm(a, Bc[j][c]))
        acc = acc + _recombine(groups) * sB[c]
    return acc * (4.0 * sA)


@_entry_point
def exact_einsum(sub: str, A, B, L: int = 4, maxdeg: int = 5, A_pre=None,
                 B_pre=None, A_shape=None, B_shape=None):
    """Two-operand einsum via exact_gemm (plain contractions only, as
    split_gemm.split_einsum).  A_pre/B_pre: prechunk_A/prechunk_B output
    for a loop-constant operand in the (fa+contr)/(contr+fb) matricised
    layout this function builds; the operand is then consulted for its
    shape only (or pass None with A_shape/B_shape in einsum order)."""
    ins, out = sub.split("->")
    sa, sb = ins.split(",")
    contr = [c for c in sa if c in sb]
    fa = [c for c in sa if c not in contr]
    fb = [c for c in sb if c not in contr]
    if set(out) != set(fa + fb) or len(set(sa)) != len(sa):
        raise ValueError(f"exact_einsum takes plain contractions only: {sub!r}")
    a_dims = A.shape if A is not None else A_shape
    b_dims = B.shape if B is not None else B_shape
    ash = tuple(a_dims[sa.index(c)] for c in fa + contr)
    bsh = tuple(b_dims[sb.index(c)] for c in contr + fb)
    M, K, N = math.prod(ash[: len(fa)]), math.prod(ash[len(fa):]), math.prod(bsh[len(contr):])
    Am = Bm = None
    if A_pre is None:
        Am = A.permute([sa.index(c) for c in fa + contr]).reshape(M, K)
    if B_pre is None:
        Bm = B.permute([sb.index(c) for c in contr + fb]).reshape(K, N)
    C = exact_gemm(Am, Bm, A_pre=A_pre, B_pre=B_pre, L=L, maxdeg=maxdeg)
    C = C.reshape(ash[: len(fa)] + bsh[len(contr):])
    return C.permute([(fa + fb).index(c) for c in out])


@_entry_point
def exact_gemm(A=None, B=None, *, A_dig=None, B_dig=None, A_pre=None,
               B_pre=None, L: int = 7, maxdeg: int = 8,
               digit_dtype: torch.dtype = F32, route: str = "int8") -> torch.Tensor:
    """(M,K) @ (K,N) f64 to ~2^-49 of the row x col scale.

    A_dig/B_dig take pre-digitized (digits, scale) pairs; A_pre/B_pre
    prechunk_A/prechunk_B outputs (the B side digitizes with as many
    limbs as the prechunked side has).  maxdeg keeps digit pairs with
    (i+1)+(j+1) <= maxdeg; 8 -> 28 pair GEMMs.

    digit_dtype picks the JAX package's recombination.  float32 (default):
    same-degree pair products summed in groups of at most six, groups
    folded into f64 in degree order (`_recombine`).  int8: every pair
    folded into f64 on its own, in (i, j) order, over the whole K (K <=
    _MAX_K).  `route` says how each pair product is computed (module
    docstring); it changes no bit of the result."""
    if A_pre is not None or B_pre is not None:
        if digit_dtype != F32:
            raise ValueError("prechunked operands take the float32 recombination")
        return _exact_gemm_pre(A, B, A_pre, B_pre, maxdeg, route)
    Ad, sA = A_dig if A_dig is not None else digitize_A(A, L)
    Bd, sB = B_dig if B_dig is not None else digitize_B(B, L)
    K = Ad[0].shape[1]
    if K != Bd[0].shape[0]:
        raise ValueError(f"contraction dims differ: {K} and {Bd[0].shape[0]}")
    if digit_dtype == torch.int8:
        if K > _MAX_K:
            raise ValueError(f"contraction dim {K} exceeds the exact-int32 bound {_MAX_K}")
        acc = None
        for i in range(len(Ad)):
            for j in range(len(Bd)):
                if i + j + 2 > maxdeg:
                    continue
                term = digit_pair_gemm(Ad[i], Bd[j], route) * 2.0 ** (-_Q * (i + j + 2))
                acc = term if acc is None else acc + term
        return acc * (4.0 * sA * sB)
    if digit_dtype != F32:
        raise ValueError(f"digit_dtype {digit_dtype}: torch.float32 or torch.int8")
    groups: dict = {}
    for i in range(len(Ad)):
        for j in range(len(Bd)):
            if i + j + 2 > maxdeg:
                continue
            _group_add(groups, i + j + 2, digit_pair_gemm(Ad[i], Bd[j], route))
    return _recombine(groups) * (4.0 * sA * sB)


def _exact_gemm_pre(A, B, A_pre, B_pre, maxdeg: int, route: str) -> torch.Tensor:
    """Digit GEMM with one or both operands prechunked.  A
    prechunk_B_chunkscaled operand carries per-chunk scales (nc, 1, N);
    each chunk's group value is then scaled before the cross-chunk
    reduction, which is no longer exact (f64 rounding)."""
    if A_pre is not None:
        Ad, sA = A_pre
    else:
        Ad, sA = digitize_A(A, len(B_pre[0]))
    if B_pre is not None:
        Bd, sB = B_pre
    else:
        Bd, sB = digitize_B(B, len(Ad))
    if sB.ndim == 3:
        # one K chunk at a time: each group's chunk value is scaled and
        # summed into that group's f64 total in chunk order, so the
        # transient is one (M, N) product per group slot, never the
        # (nc, M, N) stack (2.4 GB a pair for the trimer's vvvv term)
        nc, kc, _ = Bd[0].shape
        totals: dict = {}
        for c in range(nc):
            groups: dict = {}
            for i in range(len(Ad)):
                a = Ad[i][:, c * kc:(c + 1) * kc]
                for j in range(len(Bd)):
                    if i + j + 2 > maxdeg:
                        continue
                    _group_add(groups, i + j + 2, digit_pair_gemm(a, Bd[j][c], route))
            for k, (g, _) in groups.items():
                t = g * 2.0 ** (-_Q * k[0]) * sB[c]
                totals[k] = t if k not in totals else totals[k] + t
        acc = None
        for k in sorted(totals):
            acc = totals[k] if acc is None else acc + totals[k]
        return acc * (4.0 * sA)
    groups = {}
    for i in range(len(Ad)):
        for j in range(len(Bd)):
            if i + j + 2 > maxdeg:
                continue
            _group_add(groups, i + j + 2, digit_pair_gemm(Ad[i], Bd[j], route))
    # the same expression as the direct route, so a prechunked operand
    # moves no bit of the result
    return _recombine(groups) * (4.0 * sA * sB)


def _group_add(groups: dict, d: int, P: torch.Tensor) -> None:
    """Add a degree-d pair product into the JAX package's slots: at
    most six per slot (its f32 group sum stays below 2^24 and exact),
    the seventh same-degree pair (maxdeg=8) spilling to a second slot.
    The slot layout fixes the order of the f64 sum across groups.  A
    slot holds its running sum and count: the products are integers far
    below 2^53, so the sum is exact in any order and one (M, N) tensor
    per slot is all that stays alive."""
    n = 0
    while (d, n) in groups and groups[(d, n)][1] >= 6:
        n += 1
    if (d, n) in groups:
        slot = groups[(d, n)]
        slot[0].add_(P)  # the slot's tensor is the fresh first product
        slot[1] += 1
    else:
        groups[(d, n)] = [P, 1]


def _recombine(groups: dict) -> torch.Tensor:
    """Fold the degree-grouped pair products into one f64 result.  Each
    group's sum is an exact integer (f64 holds it), times its 2^-7d
    weight (exact); the groups accumulate in f64 in sorted (degree, slot)
    order, the JAX package's order, which makes the flat-scale result its
    bit for bit."""
    acc = None
    for k in sorted(groups):
        g = groups[k][0] * 2.0 ** (-_Q * k[0])
        acc = g if acc is None else acc + g
    return acc
