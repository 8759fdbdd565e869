"""int8 quantization and the W8A8 linear.

Counterpart of mla_tpu/ops/quantization.py. A quantized linear leaf is
{'w_q': int8 [..., in, out], 'w_scale': fp32 [..., 1, out]} and a quantized
embedding {'table_q': int8 [V, D], 'table_scale': fp32 [V, 1]}, exactly the
JAX layout, so quantized trees carry across leaf for leaf.

`w8a8_matmul` is the serving product of every int8 decoder linear by
default: per-row dynamic activation quantization, an exact int8 x int8 ->
int32 product and the fp32 rescale. It takes the weight K-major, `w_qt`
int8 [N, K] (the transpose of JAX's w_q), because the card's int8 tensor
cores read both operands K-major; the serving tree carries that copy
(models/llama.fuse_for_serving(k_major=True)). On a CUDA tensor it
launches the hand-written kernel (csrc/w8a8.cu); on a CPU tensor it runs
`w8a8_matmul_plain`, which accumulates exactly in float64 (11008 * 127^2 >
2^24, so float32 would not).

`int8_matmul` is the weight-only product (nn.linear's int8_mode
"weight_only", and the int8 lm_head in fp32 whatever the mode): the
activations stay in their dtype and the int8 weights are widened on the
way, y = (x @ float(w_q)) * w_scale. On a CUDA tensor it launches
csrc/int8_mm.cu along the path and split of K that `int8_mm_plan` picks; on
a CPU tensor it runs `int8_matmul_plain`.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional

import torch

from mla_tpu_torch.ops import cuda
from mla_tpu_torch.params import tree_to


def _div127(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127 as a true division. Dividing by a Python scalar
    would let PyTorch's CUDA kernel multiply by the reciprocal instead, which
    is one ulp off for some values (JAX and the kernel divide)."""
    return amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)


def _quantize(w: torch.Tensor, dim: int):
    wf = w.float()
    scale = _div127(wf.abs().amax(dim=dim, keepdim=True))
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor, axis: int = -2) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8: scale over the reduction axis
    (default -2 = the `in` dim of the [in, out] layout)."""
    q, scale = _quantize(w, axis)
    return {"w_q": q, "w_scale": scale}


def quantize_embedding(table: torch.Tensor) -> Dict[str, torch.Tensor]:
    q, scale = _quantize(table, -1)
    return {"table_q": q, "table_scale": scale}


def _quantize_stacked(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """quantize_weight layer by layer over a stacked [L, in, out] leaf, so
    the fp32 transient is one layer's, not the whole stack's."""
    parts = [quantize_weight(w[i]) for i in range(w.shape[0])]
    return {k: torch.stack([p[k] for p in parts]) for k in ("w_q", "w_scale")}


def _require_llama(params: Dict[str, Any]) -> None:
    """Raise unless `params` is a llama decoder tree: the JAX package
    quantizes llama trees only, so there is no int8 phi tree to mirror."""
    layers = params["layers"]
    if "input_ln" not in layers:
        family = "phi" if "ln" in layers else "unknown"
        raise ValueError(f"int8 quantization takes a llama decoder tree; this is a {family} tree "
                         "(the phi family serves and trains its bf16 tree)")


def quantize_llama(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize every big matmul of a models/llama.py tree (q/k/v/o,
    gate/up/down, lm_head, embedding). Norm scales stay as they are. Raises
    ValueError, naming the family, for any other decoder tree."""
    _require_llama(params)
    lp = params["layers"]
    return {
        "embed": quantize_embedding(params["embed"]["table"]),
        "layers": {
            "attn": {k: _quantize_stacked(lp["attn"][k]["w"]) for k in ("q", "k", "v", "o")},
            "mlp": {k: _quantize_stacked(lp["mlp"][k]["w"]) for k in ("gate", "up", "down")},
            "input_ln": lp["input_ln"],
            "post_ln": lp["post_ln"],
        },
        "final_ln": params["final_ln"],
        "lm_head": quantize_weight(params["lm_head"]["w"]),
    }


def quantize_model(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize the LLM backbone of a full MLA tree on the device its leaves
    are on; the small front-end and head modules keep their dtype."""
    out = dict(params)
    out["llm_backbone"] = quantize_llama(params["llm_backbone"])
    return out


def quantize_model_host(params: Dict[str, Any]) -> Dict[str, Any]:
    """quantize_model on the host: every leaf is moved to the CPU first and
    the int8 leaves stay there (for checkpoints that are quantized before
    they are moved to the card)."""
    _require_llama(params["llm_backbone"])
    return {**params, "llm_backbone": quantize_llama(tree_to(params["llm_backbone"], "cpu"))}


# --------------------------------------------------------------------------- #
# W8A8 product
# --------------------------------------------------------------------------- #


def quantize_rows(x: torch.Tensor):
    """Per-row dynamic activation quantization: (xq int8, s_x fp32 [M, 1])."""
    xf = x.float()
    sx = _div127(xf.abs().amax(dim=-1, keepdim=True))
    xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
    return xq, sx


def w8a8_matmul_plain(x: torch.Tensor, w_qt: torch.Tensor, w_scale: torch.Tensor, *, return_acc: bool = False):
    """The plain version: x [M, K] (fp32/bf16), w_qt int8 [N, K] (any
    strides), w_scale fp32 [N] -> y [M, N] in x's dtype (and the int32
    accumulators)."""
    xq, sx = quantize_rows(x)
    acc = (xq.double() @ w_qt.double().t()).to(torch.int32)  # exact: |acc| < 2^53
    y = (acc.float() * sx * w_scale.float().reshape(1, -1)).to(x.dtype)
    return (y, acc) if return_acc else y


# The kernel's two paths (csrc/w8a8.cu): up to W8A8_NARROW_MAX_M rows it
# streams the weights, 64 output columns a block, three or four blocks an
# SM; above, 128 x 128 output tiles, one block an SM. K runs in 128-byte
# tiles. Each path splits K over several blocks where its tiles alone
# would leave SMs idle.
W8A8_NARROW_MAX_M = 64
_K_TILE = 128
_NARROW_COLS, _NARROW_THREADS, _NARROW_BLOCKS_PER_SM = 64, 128, 3
_WIDE_TILE, _WIDE_THREADS, _WIDE_MAX_SPLITS = 128, 256, 4


class W8A8Plan(NamedTuple):
    narrow: bool
    tiles: int      # output tiles
    splits: int     # blocks per output tile, each over 1 / splits of K
    part_ints: int  # int32 scratch of the partial sums (0 without a split)


@functools.lru_cache(maxsize=None)
def w8a8_plan(M: int, K: int, N: int, sms: int) -> W8A8Plan:
    """The kernel's path and split of K for x [M, K] times a [N, K] weight
    on a card with `sms` SMs.

    Narrow (M <= W8A8_NARROW_MAX_M, bound by the weight stream): every
    block should be resident at once, so K is split until the blocks fill
    the SMs' slots, each split keeping at least four K tiles. Wide (bound by
    operations): the split (1 to 4) that minimizes the waves of blocks times
    a block's K tiles, plus four tiles' worth for its start and its partial
    sums."""
    kt = -(-K // _K_TILE)
    if M <= W8A8_NARROW_MAX_M:
        tiles = N // _NARROW_COLS
        splits = max(1, min(sms * _NARROW_BLOCKS_PER_SM // tiles, kt // 4))
        regs = 16 if M <= 32 else 32
        part = tiles * splits * _NARROW_THREADS * regs
    else:
        tiles = -(-M // _WIDE_TILE) * -(-N // _WIDE_TILE)
        costs = [(-(-tiles * s // sms) * (-(-kt // s) + 4), s)
                 for s in range(1, _WIDE_MAX_SPLITS + 1) if s == 1 or kt // s >= 4]
        splits = min(costs)[1]
        part = tiles * splits * _WIDE_THREADS * (_WIDE_TILE // 2)
    return W8A8Plan(M <= W8A8_NARROW_MAX_M, tiles, splits, part if splits > 1 else 0)


_SMS: Dict[int, int] = {}
_TICKETS: Dict[int, torch.Tensor] = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """The split-K tickets of a device: int32 zeros, one per output tile,
    which each launch of W8A8 or int8_mm leaves at zero, so one buffer
    serves every call of both (launches on a stream do not overlap)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    t = _TICKETS.get(index)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[index] = t
    return t


def w8a8_matmul(x: torch.Tensor, w_qt: torch.Tensor, w_scale: torch.Tensor, *, return_acc: bool = False):
    """Fused per-row quantization + int8 product + rescale: x [M, K] times
    the weight K-major, w_qt int8 [N, K]. On CUDA the kernel (csrc/w8a8.cu;
    K and N multiples of 64, w_qt contiguous); on the CPU the plain version.
    `return_acc` also returns the int32 accumulators."""
    if not x.is_cuda:
        return w8a8_matmul_plain(x, w_qt, w_scale, return_acc=return_acc)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"w8a8_matmul: x must be float32 or bfloat16, got {x.dtype}")
    cuda.check(x, "w8a8_matmul x", ndim=2)
    cuda.check(w_qt, "w8a8_matmul w_qt (the weight K-major, int8 [N, K], built once by "
               "models/llama.fuse_for_serving(k_major=True))", torch.int8, 2)
    w_scale = w_scale.reshape(-1)
    cuda.check(w_scale, "w8a8_matmul w_scale", torch.float32, 1)
    M, K = x.shape
    N = w_qt.shape[0]
    if w_qt.shape[1] != K or w_scale.shape[0] != N:
        raise ValueError(f"w8a8_matmul: shapes x {tuple(x.shape)}, w_qt {tuple(w_qt.shape)}, w_scale {N}")
    if K % 64 or N % 64:
        raise ValueError(f"w8a8_matmul: the kernel needs K and N multiples of 64, got K={K} N={N}")
    if x.data_ptr() % 16 or w_qt.data_ptr() % 16:
        raise ValueError("w8a8_matmul: x and w_qt must be 16-byte aligned")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    acc = torch.empty((M, N), dtype=torch.int32, device=x.device) if return_acc else None
    if M > 0:
        plan = w8a8_plan(M, K, N, _sm_count(x.device))
        xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
        sx = torch.empty((M,), dtype=torch.float32, device=x.device)
        split = plan.splits > 1
        part = torch.empty((plan.part_ints,), dtype=torch.int32, device=x.device) if split else None
        cuda.call(
            "w8a8", x.data_ptr(), 0 if x.dtype == torch.float32 else 1, w_qt.data_ptr(),
            w_scale.data_ptr(), y.data_ptr(), xq.data_ptr(), sx.data_ptr(),
            acc.data_ptr() if acc is not None else None, part.data_ptr() if split else None,
            _tickets(x.device, plan.tiles).data_ptr() if split else None, M, K, N, plan.splits,
        )
        cuda.launches["w8a8_matmul"] += 1
    return (y, acc) if return_acc else y


def _int8_leaf_linear(matmul, w: torch.Tensor, p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    lead = x.shape[:-1]
    y = matmul(x.reshape(-1, x.shape[-1]).contiguous(), w, p["w_scale"])
    y = y.reshape(*lead, y.shape[-1])
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def w8a8_linear(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """nn.linear entry for a 2-D int8 leaf; x [..., K]. Reads the leaf's
    K-major copy 'w_qt' where it has one (the W8A8 serving tree's); else
    JAX's w_q through a transposed view, which the plain version takes and
    the kernel refuses."""
    w = p["w_qt"] if "w_qt" in p else p["w_q"].transpose(-1, -2)
    return _int8_leaf_linear(w8a8_matmul, w, p, x)


# --------------------------------------------------------------------------- #
# Weight-only int8 product
# --------------------------------------------------------------------------- #


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """The plain version: x [M, K] (fp32/bf16), w_q int8 [K, N], w_scale fp32
    [1, N] or [N] -> (x @ float(w_q)) * w_scale in x's dtype. The products
    are exact (int8 and bf16 values fit fp32), the sums fp32, the scale after
    the dot in fp32, as in the JAX kernel."""
    acc = x.float() @ w_q.float()
    return (acc * w_scale.float().reshape(1, -1)).to(x.dtype)


# The kernel's two paths (csrc/int8_mm.cu): fp32 x, and bf16 x up to
# INT8_NARROW_MAX_M rows, take the weight stream on the CUDA cores: a block
# takes a group of 1, 2, 4 or 8 rows and 256 output columns (128 for 8 rows),
# two blocks an SM up to 2 rows, one above. bf16 x above the line takes the
# wgmma path: a block takes up to three 64-row blocks (as few as cover M in
# the fewest tiles) and 128 columns, one block an SM. K runs in 64-row
# tiles. Each path splits K over several blocks where its tiles alone would
# leave SMs idle. The line is where chip_smoke.py finds the wgmma path
# faster for an mla-7b layer's four linears (PERF.md).
INT8_NARROW_MAX_M = 4
_I8_K_TILE = 64
_I8_WIDE_COLS, _I8_WIDE_MAX_MB, _I8_WIDE_MAX_SPLITS = 128, 3, 4


class Int8MMPlan(NamedTuple):
    narrow: bool
    rows: int         # rows of x a block takes (narrow: its row group; wide: 64 x its m64 blocks)
    tiles: int        # output tiles (narrow: column strips x row groups)
    splits: int       # blocks per output tile, each over 1 / splits of K
    part_floats: int  # fp32 scratch of the partial sums (0 without a split)


def _best_split(tiles: int, kt: int, slots: int, start: int, partials: int, splits) -> int:
    """The split of K that minimizes the waves of blocks times a block's
    time in K tiles: its share of K, `start` tiles' worth for its start and,
    when K is split, `partials` for storing and adding its partial sums."""
    return min((-(-tiles * s // slots) * (-(-kt // s) + start + (partials if s > 1 else 0)), s) for s in splits)[1]


@functools.lru_cache(maxsize=None)
def int8_mm_plan(M: int, K: int, N: int, sms: int, fp32: bool, narrow: Optional[bool] = None) -> Int8MMPlan:
    """The kernel's path, tile and split of K for x [M, K] (fp32 or bf16)
    times an int8 [K, N] weight on a card with `sms` SMs; `narrow` forces a
    path (bf16 only; the wgmma path takes no fp32), else the line picks it.

    Narrow (fp32 x, or M <= INT8_NARROW_MAX_M; bound by the weight stream;
    a block's partial sums are at most 4 KB): the split, each keeping at
    least four K tiles, that minimizes the waves of blocks times a block's K
    tiles plus two. Wide (bound by operations): the split, 1 to 4 and at
    least eight K tiles each, that minimizes the waves times a block's K
    tiles plus four, plus three for each 64-row block whose 32 KB of partial
    sums a split writes and reads back."""
    kt = -(-K // _I8_K_TILE)
    if fp32 or (M <= INT8_NARROW_MAX_M if narrow is None else narrow):
        rows = 1 if M <= 1 else 2 if M <= 2 else 4 if M <= 4 else 8
        cols = 256 if rows <= 4 else 128
        tiles = -(-N // cols) * -(-M // rows)
        per_sm = 2 if rows <= 2 else 1
        splits = _best_split(tiles, kt, sms * per_sm, 2, 0, range(1, max(1, kt // 4) + 1))
        part = tiles * splits * 4 * 256  # one float4 per consumer thread
        return Int8MMPlan(True, rows, tiles, splits, part if splits > 1 else 0)
    blocks = -(-M // 64)
    mb = -(-blocks // -(-blocks // _I8_WIDE_MAX_MB))
    tiles = -(-M // (64 * mb)) * -(-N // _I8_WIDE_COLS)
    splits = _best_split(tiles, kt, sms, 4, 3 * mb,
                         [s for s in range(1, _I8_WIDE_MAX_SPLITS + 1) if s == 1 or kt // s >= 8])
    part = tiles * splits * 64 * mb * 128  # the tile's sums: 16 mb float4 per consumer thread
    return Int8MMPlan(False, 64 * mb, tiles, splits, part if splits > 1 else 0)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Weight-only int8 product. On CUDA the kernel (csrc/int8_mm.cu; K and
    N multiples of 16, ragged tiles masked); on the CPU the plain version."""
    if not x.is_cuda:
        return int8_matmul_plain(x, w_q, w_scale)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_matmul: x must be float32 or bfloat16, got {x.dtype}")
    cuda.check(x, "int8_matmul x", ndim=2)
    cuda.check(w_q, "int8_matmul w_q", torch.int8, 2)
    w_scale = w_scale.reshape(-1)
    cuda.check(w_scale, "int8_matmul w_scale", torch.float32, 1)
    M, K = x.shape
    N = w_q.shape[1]
    if w_q.shape[0] != K or w_scale.shape[0] != N:
        raise ValueError(f"int8_matmul: shapes x {tuple(x.shape)}, w_q {tuple(w_q.shape)}, w_scale {N}")
    if K < 16 or N < 16 or K % 16 or N % 16:
        raise ValueError(f"int8_matmul: the kernel needs K and N multiples of 16, got K={K} N={N}")
    if x.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("int8_matmul: x and w_q must be 16-byte aligned")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M > 0:
        int8_mm_launch(x, w_q, w_scale, y, int8_mm_plan(M, K, N, _sm_count(x.device), x.dtype == torch.float32))
    return y


def int8_mm_launch(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, y: torch.Tensor,
                   plan: Int8MMPlan) -> None:
    """One launch of csrc/int8_mm.cu along `plan` on tensors int8_matmul
    has checked (w_scale [N]); y [M, N] in x's dtype is written."""
    M, K = x.shape
    N = w_q.shape[1]
    split = plan.splits > 1
    part = torch.empty((plan.part_floats,), dtype=torch.float32, device=x.device) if split else None
    cuda.call("int8_mm", x.data_ptr(), 0 if x.dtype == torch.float32 else 1, w_q.data_ptr(), w_scale.data_ptr(),
              y.data_ptr(), part.data_ptr() if split else None,
              _tickets(x.device, plan.tiles).data_ptr() if split else None, M, K, N,
              0 if plan.narrow else plan.rows // 64, plan.splits)
    cuda.launches["int8_matmul"] += 1


def int8_linear(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """nn.linear entry of the weight-only mode for a 2-D {'w_q','w_scale'(,'b')}
    leaf; x [..., K]."""
    return _int8_leaf_linear(int8_matmul, p["w_q"], p, x)
