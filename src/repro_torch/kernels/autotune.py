"""Per-card grid cache for the port's CUDA kernels, and its sweep.

The launch grids of three kernels turn on a constant that the card
decides: where `simhash.grid` leaves the warp kernel for the stream
kernel (`warp_rows_per_sm`) and how many groups of 12 hyperplanes a
stream block holds (`stream_groups`, 2 or 4, the kernel's two builds);
how many (row, part) blocks an SM `bucket_topk.grid` aims for
(`parts_per_sm`); and the most rows a block of `fused_query.
contains_grid` takes (`max_rows`).  The kernels' wrappers read the
card's entry here at launch (`get(op, device_kind(device))`) and pass it
to the grid functions; `DEFAULTS` holds the modules' constants, so a
missing or empty cache changes no grid.

The cache is a JSON file next to this module keyed by
`{device_kind: {op: {params...}}}`, the format of the JAX package's
`kernels/autotune_cache.json`; `REPRO_TORCH_AUTOTUNE_CACHE` points at
another file (a sweep's scratch file, say).  The JAX package's entries
(`fused_query` / `fused_query_routed`: `tb`, `kc`) are Pallas block
shapes.  The port's fused_query has no such shape (its work items are
`ITEM_ROWS` pairs, a constant of the CUDA source), so a cache that holds
them loads and changes nothing.

`get` costs no file read, JSON parse or device-name query per launch:
the device kind is resolved once per device, the file is parsed once per
path and kept, and `put` drops what was kept.

    python -m repro_torch.kernels.autotune --sweep [--ops simhash ...] \\
        [--out PATH] [--reps N]

times every candidate of `SWEEP` at the main path's shapes on the card
(`cases`), holds each candidate's output against the kernel's plain
version first (a candidate that disagrees is an error), prints every
candidate's medians, and records an op's winner (the lowest sum of
medians over its shapes) only where it beats the defaults by more than
the defaults' own spread over their repetitions.  It needs a CUDA card
and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import json
import os
import pathlib
import sys

import torch

_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_CACHE_FILE = pathlib.Path(__file__).resolve().parent / "autotune_cache.json"

# the modules' constants: simhash.WARP_ROWS_PER_SM / STREAM_GROUPS,
# bucket_topk.PARTS_PER_SM, fused_query.CONTAINS_MAX_ROWS
DEFAULTS = {
    "*": {
        "simhash": {"warp_rows_per_sm": 96, "stream_groups": 4},
        "bucket_topk": {"parts_per_sm": 4},
        "fused_contains": {"max_rows": 16},
    },
}

# the candidates of each op's sweep; each op's default is among them
SWEEP = {
    "simhash": {"warp_rows_per_sm": (24, 48, 96, 192, 384),
                "stream_groups": (2, 4)},
    "bucket_topk": {"parts_per_sm": (1, 2, 4, 8)},
    "fused_contains": {"max_rows": (4, 8, 16, 32)},
}
SPIN_CYCLES = 20_000_000   # ~10 ms of sleep kernel ahead of a timed call

# the sweep's shapes: simhash (n, d, k, sparse) at L = 4, fused_contains
# rows (see `cases`)
SIMHASH_SHAPES = ((1024, 128, 12, False), (16_384, 128, 12, False),
                  (1_100_000, 128, 12, False), (8192, 24_576, 11, True))
CONTAINS_ROWS = (4096, 8192)


def cache_path() -> pathlib.Path:
    return pathlib.Path(os.environ.get(_CACHE_ENV, _CACHE_FILE))


def normalize_kind(name: str) -> str:
    """A device name as a cache key: stripped, lower case, '_' for ' '."""
    return name.strip().lower().replace(" ", "_")


@functools.lru_cache(maxsize=None)
def _cuda_kind(index: int) -> str:
    return normalize_kind(torch.cuda.get_device_name(index))


def device_kind(device=None) -> str:
    """The cache key of `device` (by default the current CUDA device, or
    the CPU on a host without one): its normalised name, e.g.
    "nvidia_h100_80gb_hbm3"; "cpu" for the CPU.  Resolved once per
    device."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    return _cuda_kind(torch.cuda.current_device() if dev.index is None
                      else dev.index)


@functools.lru_cache(maxsize=None)
def _load(path_str: str) -> dict:
    path = pathlib.Path(path_str)
    if not path.exists():
        return {}
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return {}


def get(op: str, kind: str | None = None) -> dict:
    """Tuned params of `op` on this device kind, over `DEFAULTS`."""
    kind = kind or device_kind()
    entry = _load(str(cache_path())).get(kind, {}).get(op, {})
    return {**DEFAULTS["*"].get(op, {}), **entry}


def put(op: str, params: dict, kind: str | None = None) -> pathlib.Path:
    """Record swept winners for `op`; returns the cache path written."""
    kind = kind or device_kind()
    path = cache_path()
    cache = dict(_load(str(path)))
    cache[kind] = {**cache.get(kind, {}), op: dict(params)}
    path.write_text(json.dumps(cache, indent=2, sort_keys=True) + "\n")
    _load.cache_clear()
    return path


# -- the sweep (card only) ---------------------------------------------------


def candidates(op: str) -> list[dict]:
    """Every combination of `SWEEP[op]`'s values."""
    names = list(SWEEP[op])
    return [dict(zip(names, vals))
            for vals in itertools.product(*(SWEEP[op][n] for n in names))]


@dataclasses.dataclass
class Case:
    """One shape of an op's sweep: `run(params)` launches the kernel on
    the grid of `params`, `plain()` is its plain version, and
    `check(got, want)` raises where they disagree (and returns a count
    of tolerated differences); `note(params)` says where the grid of
    `params` does not take the kernel variant the params ask for."""
    label: str
    run: object
    plain: object
    check: object
    note: object = None


def rep_ms(fn, reps: int) -> list[float]:
    """Device ms of each of `reps` calls of `fn` after one warm-up call
    (inputs warm in L2 where they fit): each call between its own event
    pair, enqueued while the card spins on a ~10 ms sleep kernel, so the
    host's launch pace stays out of the reading."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def _median(xs: list[float]) -> float:
    return float(torch.tensor(xs, dtype=torch.float64).median())


def simhash_band_flips(x, h, got, want, band: float = 1e-5) -> int:
    """Bits where the kernel's codes `got` differ from the plain `want`:
    allowed only where |x . h| <= band * |x| * |h| (summation order near
    a zero projection); raises on any other.  Returns the count."""
    flips = torch.bitwise_xor(got, want)
    rows = flips.ne(0).any(1).nonzero().flatten()
    if rows.numel() == 0:
        return 0
    L, k, _ = h.shape
    xr = x[rows].double()
    bits = ((flips[rows].long()[..., None] >> torch.arange(
        k, device=x.device)) & 1) > 0
    proj = torch.einsum("nd,lkd->nlk", xr, h.double())
    lim = band * torch.linalg.vector_norm(xr, dim=1)[:, None, None] \
        * torch.linalg.vector_norm(h.double(), dim=2)[None]
    outside = bits & (proj.abs() > lim)
    if bool(outside.any()):
        raise AssertionError(f"simhash: {int(outside.sum())} flipped bits "
                             "outside the near-zero band")
    return int(bits.sum())


def cases(op: str, device, seed: int = 0) -> list[Case]:
    """The sweep's shapes of `op` on `device`, with inputs made from
    `seed`: the main path's (the phase-4 shapes of `chip_smoke.py`),
    plus one shape where the candidates' grids differ that the main
    path's leave alike: simhash x [16384, 128] (the warp kernel below
    `warp_rows_per_sm` 192 and 384 on 132 SMs, the stream kernel above
    24-96) and fused_contains at 8192 rows (blocks of `max_rows` 32,
    where 4096 rows halve it to 16)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import bucket_topk as bt
    from repro_torch.kernels import fused_query as fq
    from repro_torch.kernels import simhash as sh

    g = torch.Generator(device=device).manual_seed(seed)
    sms = _build.sm_count(torch.device(device))
    out = []
    if op == "simhash":
        for n, d, k, sparse in SIMHASH_SHAPES:
            if sparse:  # one chunk of a densified OSN corpus: 32 interests
                x = torch.zeros((n, d), device=device)
                x.scatter_(1, torch.randint(0, d, (n, 32), generator=g,
                                            device=device),
                           torch.rand((n, 32), generator=g, device=device))
            else:
                x = torch.randn((n, d), generator=g, device=device)
            h = torch.randn((4, k, d), generator=g, device=device)

            def note(p, n=n, d=d, k=k):
                grid = sh.grid(n, d, k, 4, False, sms, p["warp_rows_per_sm"],
                               p["stream_groups"])
                if grid.stream or n < p["warp_rows_per_sm"] * sms:
                    return None
                staged = sh.stream_smem_bytes(d, 0, 0, p["stream_groups"])
                return (f"stream kernel skipped: its {p['stream_groups']} "
                        f"groups of hyperplanes at d={d} stage {staged} B, "
                        f"over SMEM_BLOCK {sh.SMEM_BLOCK} B; the warp "
                        "kernel runs")

            out.append(Case(
                f"x[{n},{d}] k={k} L=4",
                lambda p, x=x, h=h: sh.simhash_cuda(x, h, tuned=p),
                lambda x=x, h=h: sh.simhash_plain(x, h),
                lambda got, want, x=x, h=h: simhash_band_flips(x, h, got,
                                                               want),
                note))
    elif op == "bucket_topk":
        # small integers: every product is exact in any summation order,
        # and ties are many, so ids and scores must agree exactly
        b, kc, d, m = 128, 6656, 128, 10
        q = torch.randint(-8, 9, (b, d), generator=g, device=device).float()
        cand = torch.randint(-8, 9, (b, kc, d), generator=g,
                             device=device).float()
        vwords = bt.pack_valid(torch.rand((b, kc), generator=g,
                                          device=device) < 0.7)

        def check(got, want):
            if not torch.equal(got[1], want[1]):
                raise AssertionError("bucket_topk: ids != plain")
            err = float((got[0] - want[0]).abs().nan_to_num(0.0).max())
            if err > 4.2e-7:
                raise AssertionError(f"bucket_topk: score error {err}")
            return 0

        out.append(Case(
            f"b={b} kc={kc} d={d} m={m}",
            lambda p: bt.bucket_topk_cuda(q, cand, vwords, m, tuned=p),
            lambda: bt.bucket_topk_plain(q, cand, vwords, m), check))
    elif op == "fused_contains":
        # 4096 (query, table) rows of 13 probes over an L=4, NB=4096,
        # C=512 store about half full, as at the 1.1 M-user world
        n_rows, c, n_probes = 4 * 4096, 512, 13
        ids = torch.randint(0, 1_100_000, (n_rows, c), generator=g,
                            device=device, dtype=torch.int32)
        occ = torch.randint(128, c + 1, (n_rows, 1), generator=g,
                            device=device)
        ids[torch.arange(c, device=device) >= occ] = -1

        def check(got, want):
            if not torch.equal(got, want):
                raise AssertionError("fused_contains: hits != plain")
            return 0

        for r in CONTAINS_ROWS:
            fb = torch.randint(0, n_rows, (r, n_probes), generator=g,
                               device=device, dtype=torch.int32)
            valid = torch.rand((r, n_probes), generator=g,
                               device=device) < 0.9
            valid[:, 0] = True
            pword = (valid.int() << torch.arange(
                n_probes, device=device, dtype=torch.int32)).sum(
                1, dtype=torch.int32)
            slot = torch.randint(0, 128, (r,), generator=g, device=device)
            targets = dict(
                hit=ids[fb[:, 0].long(), slot],  # the first probe's bucket
                miss=1_100_000 + torch.arange(r, device=device,
                                              dtype=torch.int32))
            for name, tgt in targets.items():
                meta = torch.stack([pword, tgt.int()], 1).contiguous()
                assert meta.dtype == torch.int32  # the kernel reads int32
                out.append(Case(
                    f"r={r} P={n_probes} C={c} {name} traffic",
                    lambda p, fb=fb, meta=meta: fq.fused_contains_cuda(
                        ids, fb, meta, tuned=p),
                    lambda fb=fb, meta=meta: fq.fused_contains_plain(
                        ids, fb, meta),
                    check))
    else:
        raise ValueError(f"no sweep for op {op!r}")
    return out


def time_params(op_cases: list[Case], params: dict, reps: int):
    """(medians, ranges) in ms of `params` at each case."""
    meds, spans = [], []
    for case in op_cases:
        ms = rep_ms(lambda: case.run(params), reps)
        meds.append(_median(ms))
        spans.append(max(ms) - min(ms))
    return meds, spans


def sweep(ops=tuple(SWEEP), reps: int = 30, device="cuda", seed: int = 0,
          log=print) -> dict:
    """Sweep `ops` on the card (see the module docstring); returns, per
    op, `candidates` [(params, medians, ranges)], `default`, `winner` and
    whether the winner was `put` into `cache_path()`."""
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise RuntimeError("the autotune sweep times CUDA kernels: no CUDA "
                           "device is available")
    _build.build_all(("simhash", "bucket_topk", "fused_query"))
    device = torch.device(device)
    kind = device_kind(device)
    results = {}
    for op in ops:
        op_cases = cases(op, device, seed)
        default = dict(DEFAULTS["*"][op])
        wants = [case.plain() for case in op_cases]
        rows = []
        for params in candidates(op):
            for case, want in zip(op_cases, wants):
                tolerated = case.check(case.run(params), want)
                if case.note is not None and case.note(params):
                    log(f"[autotune] {op} {params} at {case.label}: "
                        f"{case.note(params)}")
                if tolerated:
                    log(f"[autotune] {op} {params} at {case.label}: "
                        f"{tolerated} sign flips within the 1e-5 band")
            meds, spans = time_params(op_cases, params, reps)
            rows.append((params, meds, spans))
            log(f"[autotune] {op} {params}: median ms "
                + ", ".join(f"{c.label} {m:.4f} (range {s:.4f})"
                            for c, m, s in zip(op_cases, meds, spans))
                + f"; sum {sum(meds):.4f}")
        best = min(rows, key=lambda row: sum(row[1]))
        base = next(row for row in rows if row[0] == default)
        gain = sum(base[1]) - sum(best[1])
        record = best[0] != default and gain > sum(base[2])
        if record:
            put(op, best[0], kind)
        log(f"[autotune] {op} on {kind}: winner {best[0]} (sum of medians "
            f"{sum(best[1]):.4f} ms) against the default {default} "
            f"({sum(base[1]):.4f} ms, its ranges summing to "
            f"{sum(base[2]):.4f} ms): "
            + (f"recorded in {cache_path()}" if record else
               "no entry recorded (the default holds within its spread)"))
        results[op] = dict(candidates=rows, default=default, winner=best[0],
                           put=record, cases=op_cases)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true", required=True,
                    help="time every candidate grid on the CUDA card")
    ap.add_argument("--ops", nargs="+", default=list(SWEEP),
                    choices=list(SWEEP))
    ap.add_argument("--out", default=None,
                    help="the cache file to record winners in (default: "
                         f"${_CACHE_ENV}, else the committed file)")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("autotune: the sweep needs a CUDA card and none is available",
              file=sys.stderr)
        return 2
    if args.out is not None:
        os.environ[_CACHE_ENV] = args.out
    print(f"[autotune] {torch.cuda.get_device_name(0)} "
          f"({device_kind()}); cache {cache_path()}", flush=True)
    sweep(args.ops, reps=args.reps, seed=args.seed,
          log=lambda *a: print(*a, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
