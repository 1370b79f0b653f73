"""Public wrappers of the kernels, with the signatures of `repro.kernels.ops`.

Each wrapper checks device, dtype, shape and contiguity, then:
  * on CPU tensors runs the kernel's plain PyTorch version;
  * on CUDA tensors launches the CUDA kernel on the current stream, and
    counts the launch in `LAUNCHES`, or raises.  There is no fallback.

Tile padding is each kernel's own business.  simhash and bucket_topk
take grids that their modules pick from the shapes and the card's SM
count (`simhash.grid`, `bucket_topk.grid`); the other kernels' block
shapes are constants in the CUDA sources.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bucket_topk as _bt
from repro_torch.kernels import fused_query as _fq
from repro_torch.kernels import hamming as _hm
from repro_torch.kernels import simhash as _sh

# kernel launches since the last `reset_launches()` (CUDA tensors only)
LAUNCHES = {"simhash": 0, "fused_query": 0, "fused_contains": 0,
            "bucket_topk": 0, "hamming_words": 0, "hamming": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(op: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix, on
    another device type, or on a tensor the kernel cannot take as laid
    out."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{op}: inputs lie on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{op}: the CUDA kernel needs contiguous inputs")
    return True


def _check_dtype(op: str, name: str, t: torch.Tensor, dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")


def simhash(x: torch.Tensor, hyperplanes: torch.Tensor, *,
            packed: bool = False) -> torch.Tensor:
    """LSH sketch codes: int32 [n, L] per-table codes, or with packed=True
    dense words int32 [n, ceil(L*k/32)].  Matches `ref.simhash_ref`
    (resp. its `pack_codes` composition)."""
    if x.dim() != 2 or hyperplanes.dim() != 3 \
            or x.shape[1] != hyperplanes.shape[2]:
        raise ValueError(
            f"simhash: x [n, d] and hyperplanes [L, k, d] expected, got "
            f"{tuple(x.shape)} and {tuple(hyperplanes.shape)}")
    if not _on_card("simhash", x, hyperplanes):
        return _sh.simhash_plain(x, hyperplanes, packed=packed)
    _check_dtype("simhash", "x", x, torch.float32)
    _check_dtype("simhash", "hyperplanes", hyperplanes, torch.float32)
    out = _sh.simhash_cuda(x, hyperplanes, packed=packed)
    LAUNCHES["simhash"] += 1
    return out


def bucket_topk(q: torch.Tensor, cand: torch.Tensor, valid: torch.Tensor,
                m: int):
    """Fused score + top-m: (scores f32 [b, m], idx int32 [b, m]), idx
    into kc and -1 where no valid candidate is left.  Matches
    `ref.bucket_topk_ref` (ties -> lowest index).  Validity travels to
    the kernel as bitfield words."""
    if cand.dim() != 3 or q.shape != (cand.shape[0], cand.shape[2]) \
            or valid.shape != cand.shape[:2]:
        raise ValueError(
            f"bucket_topk: q [b, d], cand [b, kc, d], valid [b, kc] "
            f"expected, got {tuple(q.shape)}, {tuple(cand.shape)}, "
            f"{tuple(valid.shape)}")
    _check_dtype("bucket_topk", "valid", valid, torch.bool)
    vwords = _bt.pack_valid(valid)
    if not _on_card("bucket_topk", q, cand, vwords):
        return _bt.bucket_topk_plain(q, cand, vwords, m)
    _check_dtype("bucket_topk", "q", q, torch.float32)
    _check_dtype("bucket_topk", "cand", cand, torch.float32)
    if min(cand.shape[:2]) == 0 or m == 0:  # nothing to launch
        return (torch.full((cand.shape[0], m), float("-inf"), device=q.device),
                torch.full((cand.shape[0], m), -1, dtype=torch.int32,
                           device=q.device))
    out = _bt.bucket_topk_cuda(q, cand, vwords, m)
    LAUNCHES["bucket_topk"] += 1
    return out


def hamming(codes: torch.Tensor, cand_codes: torch.Tensor) -> torch.Tensor:
    """Hamming distances int32 [n, kc].

    Single-word codes ([n] vs [n, kc]) match `ref.hamming_ref`; packed
    rows ([n, W] vs [n, kc, W], the `core.packed` layout, the staged
    scorer of `score="hamming"`) match `ref.hamming_words_ref`.  Words
    are int32 bit patterns."""
    words = cand_codes.dim() == 3
    op = "hamming_words" if words else "hamming"
    lead = cand_codes.shape[:1] + cand_codes.shape[2:]
    if cand_codes.dim() not in (2, 3) or codes.shape != lead:
        raise ValueError(
            f"{op}: codes [n] and cand [n, kc], or codes [n, W] and cand "
            f"[n, kc, W] expected, got {tuple(codes.shape)} and "
            f"{tuple(cand_codes.shape)}")
    if not _on_card(op, codes, cand_codes):
        plain = _hm.hamming_words_plain if words else _hm.hamming_plain
        return plain(codes, cand_codes)
    _check_dtype(op, "codes", codes, torch.int32)
    _check_dtype(op, "cand_codes", cand_codes, torch.int32)
    if cand_codes.numel() == 0:  # nothing to launch
        return torch.empty(cand_codes.shape[:2], dtype=torch.int32,
                           device=cand_codes.device)
    out = (_hm.hamming_words_cuda if words else _hm.hamming_cuda)(
        codes, cand_codes)
    LAUNCHES[op] += 1
    return out


def _check_rows(op: str, ids_flat, fb, meta) -> None:
    if ids_flat.dim() != 2 or fb.dim() != 2 or meta.shape != (fb.shape[0], 2):
        raise ValueError(
            f"{op}: ids_flat [R, C], fb [r, P], meta [r, 2] expected, got "
            f"{tuple(ids_flat.shape)}, {tuple(fb.shape)}, "
            f"{tuple(meta.shape)}")
    if fb.shape[1] > _fq.MAX_PROBES:
        raise ValueError(
            f"{op}: {fb.shape[1]} probes exceed the {_fq.MAX_PROBES} bits "
            "of the probe-validity word")
    for name, t in (("ids_flat", ids_flat), ("fb", fb), ("meta", meta)):
        _check_dtype(op, name, t, torch.int32)


def fused_query(
    ids_flat: torch.Tensor,  # int32 [T*NB, C] bucket slot ids (-1 = empty)
    pay_flat: torch.Tensor,  # [T*NB, C, D] f32 or [T*NB, C, W] int32 words
    q: torch.Tensor,         # [r, D] f32 queries or [r, W] int32 words
    fb: torch.Tensor,        # int32 [r, P] flattened bucket row per probe
    meta: torch.Tensor,      # int32 [r, 2] (probe-validity word, exclude id)
    *,
    m: int,
    score: str = "dot",
):
    """Fused gather -> score -> top-m: (ids int32 [r, m], scores f32
    [r, m]).  Matches `ref.fused_query_ref`, which runs the staged path
    through `core.scoring.dedupe_topk`."""
    _check_rows("fused_query", ids_flat, fb, meta)
    if pay_flat.dim() != 3 or pay_flat.shape[:2] != ids_flat.shape \
            or q.shape != (fb.shape[0], pay_flat.shape[2]):
        raise ValueError(
            f"fused_query: pay_flat [R, C, DW] and q [r, DW] expected, got "
            f"{tuple(pay_flat.shape)} and {tuple(q.shape)}")
    if score not in ("dot", "hamming"):
        raise ValueError(f"unknown score mode: {score!r}")
    want = torch.float32 if score == "dot" else torch.int32
    _check_dtype("fused_query", "pay_flat", pay_flat, want)
    _check_dtype("fused_query", "q", q, want)
    if not _on_card("fused_query", ids_flat, pay_flat, q, fb, meta):
        return _fq.fused_query_plain(ids_flat, pay_flat, q, fb, meta, m=m,
                                     score=score)
    out = _fq.fused_query_cuda(ids_flat, pay_flat, q, fb, meta, m=m,
                               score=score)
    LAUNCHES["fused_query"] += 1
    return out


def fused_contains(ids_flat: torch.Tensor, fb: torch.Tensor,
                   meta: torch.Tensor) -> torch.Tensor:
    """Fused membership probe: bool [r].  Matches `ref.fused_contains_ref`;
    reads no payload, so it serves ids-only stores too."""
    _check_rows("fused_contains", ids_flat, fb, meta)
    if not _on_card("fused_contains", ids_flat, fb, meta):
        return _fq.fused_contains_plain(ids_flat, fb, meta)
    if fb.shape[0] == 0 or ids_flat.numel() == 0:  # nothing to launch
        return torch.zeros(fb.shape[0], dtype=torch.bool, device=fb.device)
    out = _fq.fused_contains_cuda(ids_flat, fb, meta)
    LAUNCHES["fused_contains"] += 1
    return out
