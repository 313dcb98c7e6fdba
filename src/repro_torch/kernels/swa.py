"""Sliding-window attention (kernel K5) and its plain version.

The port's counterpart of ``repro.kernels.swa``: windowed-causal GQA
attention, where query position ``q`` attends to keys ``k`` with
``q - W < k <= q``.  q is ``(B, Hq, S, D)``, k/v ``(B, Hkv, S, D)`` with
``Hq % Hkv == 0``; scores are f32 ``q.k * (1/sqrt(D))``, optionally
soft-capped as ``softcap * tanh(s / softcap)``, then masked, softmaxed
over the window and applied to v in f32; the output takes q's dtype.

* :func:`swa_ref` — the dense masked oracle (every query against every
  key), ported op for op from the reference;
* :func:`sliding_window_attention_plain` — the plain version of K5: the
  reference kernel's algorithm, K/V front-padded by ``W - 1``, one
  ``tq + W - 1`` key window per query tile and a full softmax per tile;
* :func:`sliding_window_attention` — the wrapper: the plain version for a
  CPU tensor; for a CUDA tensor it launches K5 (replaces
  ``repro/kernels/swa.py`` ``_kernel``) or raises.  Every dtype runs on
  the tensor cores: bfloat16 and float16 in ``csrc/swa_wgmma.cu`` (TMA
  ring, wgmma Q.K^T, P.V with P split into :data:`TC_TERMS` bf16 or
  :data:`TC_TERMS_F16` f16 terms), float32 in ``csrc/swa_tf32.cu``
  (mma.sync in three TF32 passes, each operand split into a big and a
  small half).  Both walk each query block's valid key range in chunks
  with a running max and sum (online softmax) instead of materialising
  the window's scores, so they compute the same function without the
  front pad.  Their launches count in ``engine.LAUNCHES["K5"]``.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .engine import LAUNCHES

NEG_INF = -1e30

#: K5's CUDA source and C entry per dtype, all on the tensor cores.
_ENTRY = {torch.float32: ("swa_tf32.cu", "casper_swa_tf32"),
          torch.float16: ("swa_wgmma.cu", "casper_swa_tc_f16"),
          torch.bfloat16: ("swa_wgmma.cu", "casper_swa_tc_bf16")}
#: Head dims K5 is instantiated for (both sources).
HEAD_DIMS = (16, 32, 64, 128, 256)


def instance_dim(d: int) -> int:
    """The built head dim that serves head dim ``d``: the smallest of
    :data:`HEAD_DIMS` at least ``d``; 0 unless ``d`` is a multiple of 16
    in [16, 256] (nemotron4_340b's 192 runs on 256, zamba2_7b's 112 on
    128)."""
    if d % 16 or not 16 <= d <= HEAD_DIMS[-1]:
        return 0
    return next(h for h in HEAD_DIMS if h >= d)

# The tensor-core kernels' block geometry (csrc/swa_common.cuh), also
# walked by the CPU mirror of their arithmetic in the tests.
#: Query rows per CTA: two warpgroups of wgmma's 64 (swa_wgmma.cu), eight
#: warps of mma.sync's 16 (swa_tf32.cu).
TC_ROWS = 128
#: bf16 terms P is split into for P.V on the tensor cores.
TC_TERMS = 3
#: f16 terms P * 2**15 is split into for P.V on the tensor cores.
TC_TERMS_F16 = 2
#: The scale of P before its f16 split (undone in the final division).
TC_P_SCALE_F16 = 2.0 ** 15


def tc_chunk_keys(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Keys per K/V chunk of K5's kernel for ``dtype`` at head dim ``d``:
    128 (64 at D = 256) in swa_wgmma.cu, 64 (32 at D = 256) in
    swa_tf32.cu."""
    wide = instance_dim(d) == 256
    if dtype == torch.float32:
        return 32 if wide else 64
    return 64 if wide else 128


def tc_positions(g: int) -> int:
    """Query positions per CTA of the tensor-core kernel for ``g`` query
    heads in the CTA: ``TC_ROWS // g`` rounded down to a multiple of 8
    (each head's rows are one TMA box, which starts on a swizzle atom of
    8 rows); 0 where ``g > 16`` (more heads than one CTA holds)."""
    return TC_ROWS // g // 8 * 8


def tc_heads_per_cta(g: int) -> int:
    """Query heads per CTA of the tensor-core kernel for ``g`` query
    heads per KV head: all ``g`` up to 16; above, the group is split into
    ``ceil(g / 16)`` CTAs of equal size (the last one smaller where it
    does not divide), each reading the KV head's K/V itself."""
    split = -(-g // 16)
    return -(-g // split)


def swa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
            softcap: float | None = None) -> torch.Tensor:
    """Dense windowed-causal attention oracle (the kernel's ground
    truth).  q:(B,Hq,S,D), kv:(B,Hkv,S,D)."""
    b, hq, s, d = q.shape
    _, hkv, _, _ = k.shape
    g = hq // hkv
    kk = torch.repeat_interleave(k, g, dim=1)
    vv = torch.repeat_interleave(v, g, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          kk.float()) / math.sqrt(d)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    mask = (k_pos <= q_pos) & (k_pos > q_pos - window)
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)


def _check_shapes(q, k, v, window: int, tq: int) -> tuple[int, ...]:
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q and k must be (B, H, S, D), got {tuple(q.shape)}"
                         f" and {tuple(k.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if tuple(k.shape) != (b, hkv, s, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if int(window) < 1 or int(tq) < 1:
        raise ValueError(f"window and tq must be >= 1, got {window}, {tq}")
    return b, hq, hkv, s, d


def sliding_window_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, window: int,
                                   tq: int = 128,
                                   softcap: float | None = None
                                   ) -> torch.Tensor:
    """Plain version of K5 on any device: the reference kernel's tiling.
    K/V are front-padded by ``W - 1`` (and back-padded to whole tiles),
    query tile ``i`` (its ``G`` heads folded in) meets the key window
    ``[i*tq - (W-1), i*tq + tq)``, and each tile takes a full softmax
    over its window, all tiles in one einsum; padded query rows are
    computed and dropped."""
    b, hq, hkv, s, d = _check_shapes(q, k, v, window, tq)
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    pad_s = -s % tq
    n_tiles = (s + pad_s) // tq
    kw = tq + window - 1
    qg = F.pad(q.reshape(b, hkv, g, s, d), (0, 0, 0, pad_s))
    qg = qg.reshape(b, hkv, g, n_tiles, tq, d)
    # (B, Hkv, n_tiles, D, kw): tile i's key window, a view of the pad
    kwin = F.pad(k, (0, 0, window - 1, pad_s)).unfold(2, kw, tq)
    vwin = F.pad(v, (0, 0, window - 1, pad_s)).unfold(2, kw, tq)
    base = torch.arange(n_tiles, device=q.device)[:, None, None] * tq
    q_pos = base + torch.arange(tq, device=q.device)[:, None]
    k_pos = base - (window - 1) + torch.arange(kw, device=q.device)
    valid = (k_pos >= 0) & (k_pos <= q_pos) & (k_pos > q_pos - window)
    sc = torch.einsum("bhgnqd,bhndk->bhgnqk", qg.float(),
                      kwin.float()) * scale
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    sc = torch.where(valid, sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgnqk,bhndk->bhgnqd", p, vwin.float()) / denom
    out = out.to(q.dtype).reshape(b, hkv, g, n_tiles * tq, d)[:, :, :, :s]
    return out.reshape(b, hq, s, d)


# ---------------------------------------------------------------------------
# The C interface
# ---------------------------------------------------------------------------
class SwaTcArgs(ctypes.Structure):
    """Mirrors struct SwaTcArgs in csrc/swa_common.cuh (both sources)."""
    _fields_ = [
        ("batch", ctypes.c_int), ("hq", ctypes.c_int), ("hkv", ctypes.c_int),
        ("seq", ctypes.c_int), ("head_dim", ctypes.c_int),
        ("window", ctypes.c_int), ("positions", ctypes.c_int),
        ("heads", ctypes.c_int), ("has_softcap", ctypes.c_int),
        ("scale", ctypes.c_float), ("softcap", ctypes.c_float),
    ]


# per source: the prefix of its helpers (``_args_size``, ``_error_string``,
# ``_smem_bytes``)
_C_API = {"swa_tf32.cu": "casper_swa_tf32", "swa_wgmma.cu": "casper_swa_tc"}


def _lib(source: str) -> ctypes.CDLL:
    lib = _build.load(source)
    if not getattr(lib, "_swa_bound", False):
        prefix = _C_API[source]
        for src, name in _ENTRY.values():
            if src == source:
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6
                fn.restype = ctypes.c_int
        size = getattr(lib, f"{prefix}_args_size")
        size.argtypes, size.restype = [], ctypes.c_int
        errs = getattr(lib, f"{prefix}_error_string")
        errs.argtypes, errs.restype = [ctypes.c_int], ctypes.c_char_p
        if size() != ctypes.sizeof(SwaTcArgs):
            raise RuntimeError(
                f"SwaTcArgs layout mismatch ({source}): C {size()} bytes, "
                f"Python {ctypes.sizeof(SwaTcArgs)}")
        lib._swa_bound = True
    return lib


def _launch(q, k, v, out, window: int, tq: int,
            softcap: float | None) -> None:
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    source, entry = _ENTRY[q.dtype]
    heads = tc_heads_per_cta(hq // hkv)
    # a window longer than the sequence means the same as S; the query
    # tile tq does not change the result and the kernels take none
    a = SwaTcArgs(batch=b, hq=hq, hkv=hkv, seq=s, head_dim=d,
                  window=min(int(window), s), positions=tc_positions(heads),
                  heads=heads, has_softcap=int(softcap is not None),
                  scale=1.0 / math.sqrt(d),
                  softcap=0.0 if softcap is None else float(softcap))
    lib = _lib(source)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, entry)(
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), ctypes.addressof(a), stream)
    if err:
        msg = getattr(lib, f"{_C_API[source]}_error_string")(err)
        raise RuntimeError(f"K5 launch failed ({source}): {msg.decode()}")
    LAUNCHES["K5"] += 1


def tc_smem_bytes(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory per CTA of K5's kernel for ``dtype`` at head
    dim ``d``, as the built library reports it (needs nvcc)."""
    source = _ENTRY[dtype][0]
    fn = getattr(_lib(source), f"{_C_API[source]}_smem_bytes")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(int(d))


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, window: int, tq: int = 128,
                             softcap: float | None = None) -> torch.Tensor:
    """Windowed-causal GQA attention, ``(B, Hq, S, D)`` out in q's dtype.

    On CPU tensors: :func:`sliding_window_attention_plain`.  On CUDA
    tensors: one K5 launch, or an error — K5 takes contiguous, 16-byte
    aligned float32, float16 or bfloat16 q/k/v of one dtype with ``D`` a
    multiple of 16 up to 256, and any ``tq >= 1`` (the query tile; the
    result does not depend on it).  Every dtype runs on the tensor cores:
    bfloat16 and float16 on wgmma, float32 in three TF32 passes."""
    b, hq, hkv, s, d = _check_shapes(q, k, v, window, tq)
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v on different devices: {devices}")
    if q.device.type == "cpu":
        return sliding_window_attention_plain(q, k, v, window, tq, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K5 takes float32, float16 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not instance_dim(d):
        raise ValueError(f"K5 takes head dims that are multiples of 16 up "
                         f"to {HEAD_DIMS[-1]}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"K5 needs a contiguous, 16-byte aligned {name}")
    if s >= 2 ** 30:
        raise ValueError(f"K5 takes sequences below 2**30, got {s}")
    out = torch.empty_like(q)
    if out.numel():
        _launch(q, k, v, out, window, tq, softcap)
    return out
