"""Wrapper of the flash-attention kernel: GQA, masks and CPU/CUDA dispatch.

``flash_attention(q, k, v, causal=, window=, q_offset=, kv_len=,
prefix_len=)`` takes q ``[B, Sq, H, hd]`` and k, v ``[B, Skv, Hkv, hd]``
(the JAX package's layouts) and returns ``[B, Sq, H, hd]``.  Query ``i``
sits at position ``q_offset + i`` and key ``j`` at position ``j``; keys
``j >= kv_len`` are padding; keys ``j < prefix_len`` are seen by every
query whatever ``causal`` and ``window`` say (the prefix-LM mask of a vlm's
image positions).  GQA is handled in the kernel: one launch per call, the block of
query head ``h`` reading key/value head ``h // (H // Hkv)``.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/flash_attention.cu``) on the current stream and adds one to its
count in :data:`LAUNCHES`: bf16 inputs run on the tensor cores (bf16
products, f32 sums, p rounded to bf16 for p.v), float32 inputs on the FP32
cores, their keys split over a cluster of :func:`fp32_splits` CTAs where
the q tiles alone would leave SMs idle (float32 launches are also counted
in :data:`FP32_LAUNCHES`).  On a CPU tensor it runs the plain version in
``ref`` and counts nothing.  There is no fallback from one to the other: a
build or launch failure raises.

The launch is the custom op ``torch.ops.repro_torch.flash_attention``
(:func:`flash_attention_op`): its real implementation is the launch, its
fake implementation (``register_fake``) gives the output's shape and dtype
and never builds or loads the library, so a step runs on fake CUDA tensors
or on meta tensors, which the wrapper routes as CUDA ones (no data: the
dry run, ``launch/dryrun.py``), and ``FlopCounterMode`` counts it by
:func:`flash_flops`: 4 · H · hd a (query, key) pair the masks leave, per
batch row, not the padded tiles.

Gradients.  When an input requires a gradient, a CUDA call goes through
:class:`FlashAttentionFn`: its forward is the same launch (counted the
same way), and it saves q, k, v and the output; its backward is the plain
flash backward ``ref.flash_attention_bwd_ref`` (the JAX package has no
Pallas backward either: it trains through its XLA attention).  On the CPU
autograd differentiates the plain forward directly.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.contract import H100_SMS, KernelContract, TileSpec
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_gqa_ref)

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"flash_attention": 0}
#: float32 launches (``flash_fp32_kernel``) since the process started, of
#: the launches :data:`LAUNCHES` counts; never reset
FP32_LAUNCHES = {"flash_fp32_kernel": 0}

#: head dims the kernels are instantiated for (``csrc/flash_attention.cu``):
#: the reduced configs (16), the windowed case (64), starcoder2-7b,
#: qwen2-72b and mistral-large-123b (128), stablelm-12b (160),
#: recurrentgemma-2b (256; the tensor-core kernel's chunks are 64 keys there)
HEAD_DIMS = (16, 64, 128, 160, 256)
#: dtype codes of the C entry
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None
#: SM count per CUDA device index (:func:`_sm_count`)
_SMS: dict = {}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library("flash_attention").fg_flash_attention
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ll, ll, ll, ll, i, i,
                       i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"want q [B,Sq,H,hd] and k, v [B,Skv,Hkv,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[2]} key/value heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v must share a device; got {q.device}, "
                         f"{k.device}, {v.device}")


def _rows(x, name):
    """(batch stride, sequence stride) of ``x [B, S, heads, hd]``, whose
    last two dims must be contiguous."""
    if x.stride(3) != 1 or x.stride(2) != x.shape[3]:
        raise ValueError(f"{name}: the (heads, hd) dims must be contiguous; "
                         f"strides {x.stride()}")
    return x.stride(0), x.stride(1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, kv_len: Optional[int] = None,
                    prefix_len: Optional[int] = None) -> torch.Tensor:
    """Blocked online-softmax attention, output in the input dtype.  k and v
    may be strided views (a prefix of a KV cache) as long as their (heads,
    hd) dims are contiguous and their strides agree; for bf16 (read by the
    TMA) every base address must be 16-byte aligned and every stride a
    multiple of 8 elements."""
    _check(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive; got {window}")
    if q.device.type == "cpu":
        return flash_attention_gqa_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, kv_len=kv_len,
                                       prefix_len=prefix_len)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    masks = (bool(causal), None if window is None else int(window),
             int(q_offset), None if kv_len is None else int(kv_len),
             None if prefix_len is None else int(prefix_len))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, *masks)
    return flash_attention_op(q, k, v, *masks)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: Optional[int], q_offset: int,
                       kv_len: Optional[int],
                       prefix_len: Optional[int]) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors on the current
    device (:func:`_launch`, counted)."""
    return _launch(q, k, v, causal, window, q_offset, kv_len, prefix_len)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, window, q_offset, kv_len,
                          prefix_len):
    return q.new_empty(q.shape)


def attention_pairs(sq: int, skv: int, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    prefix_len: Optional[int] = None) -> int:
    """The (query, key) pairs of one head and batch row that
    ``ref.attention_mask`` keeps: query ``i`` at ``q_offset + i`` sees the
    keys ``[lo, hi)`` (``hi = q_pos + 1`` when causal, ``lo = q_pos -
    window + 1`` with a window) and every key below ``prefix_len``, all
    below ``kv_len``.  Host arithmetic (numpy): it runs inside a fake
    tensor mode too."""
    kv = skv if kv_len is None else max(0, min(int(kv_len), skv))
    pre = 0 if prefix_len is None else max(0, min(int(prefix_len), kv))
    q_pos = np.arange(sq, dtype=np.int64) + int(q_offset)
    hi = np.minimum(q_pos + 1, kv) if causal else np.full_like(q_pos, kv)
    lo = (np.maximum(q_pos - int(window) + 1, 0) if window is not None
          else np.zeros_like(q_pos))
    band = np.maximum(hi - np.maximum(lo, pre), 0)
    return int(pre * sq + int(band.sum()))


def flash_flops(q_shape, k_shape, causal=True, window=None, q_offset=0,
                kv_len=None, prefix_len=None) -> int:
    """FLOPs of one call: ``4 · B · H · hd`` a kept (query, key) pair
    (:func:`attention_pairs`), two for ``q · k`` and two for ``p · v``."""
    B, Sq, H, hd = q_shape
    return 4 * B * H * hd * attention_pairs(
        Sq, k_shape[1], causal=causal, window=window, q_offset=q_offset,
        kv_len=kv_len, prefix_len=prefix_len)


def _register_flop_formula() -> None:
    from torch.utils import flop_counter

    target = torch.ops.repro_torch.flash_attention
    if target in flop_counter.flop_registry:
        return

    @flop_counter.register_flop_formula(target)
    def _flops(q_shape, k_shape, v_shape, causal, window, q_offset, kv_len,
               prefix_len, *args, out_shape=None, **kwargs) -> int:
        return flash_flops(q_shape, k_shape, causal, window, q_offset,
                           kv_len, prefix_len)


_register_flop_formula()


class FlashAttentionFn(torch.autograd.Function):
    """B6 with a gradient: the forward launches the kernel, the backward
    is the plain flash backward (``ref.flash_attention_bwd_ref``).  Called
    by :func:`flash_attention` on CUDA tensors that require a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_len, prefix_len):
        out = flash_attention_op(q, k, v, causal, window, q_offset, kv_len,
                                 prefix_len)
        ctx.save_for_backward(q, k, v, out)
        ctx.masks = dict(causal=causal, window=window, q_offset=q_offset,
                         kv_len=kv_len, prefix_len=prefix_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, dout,
                                             **ctx.masks)
        return dq, dk, dv, None, None, None, None, None


def _sm_count(device) -> int:
    """The card's SM count, read once per device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _launch(q, k, v, causal, window, q_offset, kv_len, prefix_len):
    """One launch of the kernel on checked CUDA tensors on the current
    device (counted)."""
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention: tensors on {q.device} but the "
                         f"current device is cuda:"
                         f"{torch.cuda.current_device()}")
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: no kernel for {q.dtype}; it takes "
                         f"{sorted(str(d) for d in _DTYPES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: no kernel for head_dim {hd}; it "
                         f"is built for {HEAD_DIMS}")
    q_bs, q_ss = _rows(q, "q")
    kv_strides = _rows(k, "k")
    if _rows(v, "v") != kv_strides:
        raise ValueError(f"k and v strides differ: {k.stride()} vs "
                         f"{v.stride()}")
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:2]):
                raise ValueError(f"flash_attention: bf16 {name} needs a "
                                 f"16-byte aligned base and strides that "
                                 f"are multiples of 8; strides "
                                 f"{x.stride()}")
    kv_len = Skv if kv_len is None else max(0, min(int(kv_len), Skv))
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    splits = (fp32_splits(B, Sq, Skv, H, hd, _sm_count(q.device))
              if q.dtype == torch.float32 else 1)
    rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   _DTYPES[q.dtype], B, Sq, Skv, H, Hkv, hd, q_bs, q_ss,
                   *kv_strides, int(q_offset), kv_len, int(bool(causal)),
                   0 if window is None else int(window),
                   0 if prefix_len is None else max(0, int(prefix_len)),
                   1.0 / (hd ** 0.5), splits,
                   torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["flash_attention"] += 1
    if q.dtype == torch.float32:
        FP32_LAUNCHES["flash_fp32_kernel"] += 1
    return out


# ---------------------------------------------------------------------------
# static contracts (kernels/contract.py)

#: csrc/flash_attention.cu: the float32 kernel's kQT, kKC, kThreads,
#: kThreadsWide (at hd 128), kMaxSplits; the tensor-core kernel's kTcRows,
#: kTcThreads
_QT, _KC, _THREADS, _THREADS_WIDE, _MAX_SPLITS = 64, 64, 256, 128, 8
_TC_ROWS, _TC_THREADS = 128, 384
_SMEM_MAX = 232_448


def fp32_threads(hd: int) -> int:
    """Threads of one float32 block (``F32Shape<HD>::T``)."""
    return _THREADS_WIDE if hd == 128 else _THREADS


def fp32_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of the float32 kernel (``F32Shape<HD>::kSmem``,
    ``csrc/flash_attention.cu``): the q tile ``[kQT][hd]``, two stages (one
    at hd 128 and 256) of K and of V ``[kKC][hd]`` and P ``[kKC][kQT]``, in
    floats."""
    stages = 1 if hd in (128, 256) else 2
    return 4 * (_QT * hd + 2 * stages * _KC * hd + _KC * _QT)


def fp32_blocks_per_sm(hd: int) -> int:
    """Float32 blocks an SM holds (``F32Shape<HD>::MB``): two up to hd 128,
    one above."""
    return 2 if hd <= 128 else 1


def fp32_splits(B: int, Sq: int, Skv: int, H: int, hd: int,
                sms: int = H100_SMS) -> int:
    """Key splits of a float32 launch, the CTAs of one cluster: doubled
    from 1 while the grid holds fewer than two blocks for each block the
    SMs hold at once and each split keeps at least two of ``Skv``'s 64-key
    chunks, up to the portable cluster of 8.  The second wave also shortens
    a causal grid's tail: its heaviest q tile is split too."""
    tiles = -(-Sq // _QT) * H * B
    slots = sms * fp32_blocks_per_sm(hd)
    chunks = -(-Skv // _KC)
    splits = 1
    while (splits < _MAX_SPLITS and tiles * splits < 2 * slots
           and chunks >= 4 * splits):
        splits *= 2
    return splits


def tc_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of the bf16 tensor-core kernel
    (``TcShape<HD>::kSmem``, ``csrc/flash_attention.cu``:345): the q tile
    of 128 rows, two or three stages of K and V chunks (128 keys, 64 past
    hd 160), the barriers and 1 KB of alignment slack."""
    q = _TC_ROWS * hd * 2
    kv = (64 if hd > 160 else 128) * hd * 2
    stages = 3 if q + 3 * 2 * kv + 128 + 1024 <= _SMEM_MAX else 2
    return q + 2 * stages * kv + 128 + 1024


def _contract(hd: int, dtype: str, B: int, Sq: int, Skv: int, H: int,
              model: str) -> KernelContract:
    if dtype == "bfloat16":
        out = (TileSpec("out", (B, Sq, H, hd), (1, _TC_ROWS, 1, hd)),)
        tiles = Sq // _TC_ROWS * H * B
        return KernelContract(
            name="flash_attention", module=__name__,
            kernel=f"flash_tc_kernel<{hd}>", grid=(tiles,),
            threads=_TC_THREADS, smem_bytes=tc_smem_bytes(hd),
            ctas=min(tiles, H100_SMS), out_tiles=out, wired=True,
            note=model, args=(("dtype", 1), ("head_dim", hd)))
    # a cluster of `splits` CTAs a q tile, each writing _QT / splits rows
    splits = fp32_splits(B, Sq, Skv, H, hd)
    out = (TileSpec("out", (B, Sq, H, hd), (1, _QT // splits, 1, hd)),)
    return KernelContract(
        name="flash_attention", module=__name__,
        kernel=f"flash_fp32_kernel<{hd}>", grid=(Sq // _QT * H * splits, B),
        threads=fp32_threads(hd), cluster=splits,
        smem_bytes=fp32_smem_bytes(hd),
        out_tiles=out, wired=True, note=model,
        args=(("dtype", 0), ("head_dim", hd)))


#: (head dim, B, Sq, Skv, H, the prefill it is): whisper-base's encoder,
#: starcoder2-7b's 4096-token prefill, one rank's rows of
#: recurrentgemma-2b's 2048-token prefill under "seq" at a model axis of 4
_SHAPES = ((64, 1, 1536, 1536, 8, "whisper-base encoder"),
           (128, 1, 4096, 4096, 36, "starcoder2-7b prefill"),
           (256, 1, 512, 2048, 10, "recurrentgemma-2b seq rank"))
CONTRACTS = tuple(_contract(hd, dtype, B, Sq, Skv, H, model)
                  for hd, B, Sq, Skv, H, model in _SHAPES
                  for dtype in ("bfloat16", "float32"))


def library_smem_bytes(c: KernelContract) -> int:
    """The built library's own count (``fg_flash_attention_smem``)."""
    fn = _build.library("flash_attention").fg_flash_attention_smem
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn(c.arg("dtype"), c.arg("head_dim")))
