"""Capacitated compaction / routing shared across the system (DESIGN.md
Sec. 3.2).

One mechanism, two uses here:
  * the bucket store's ring append ranks each entry within its
    destination bucket to pick a write slot (`run_ranks`);
  * the all_to_all query router ranks each (query, table) within its
    destination node to pick a slot in the padded per-destination send
    buffer (`plan_routes` / `build_send_buffer` / `return_to_origin`).

The router is batched over a leading group axis: group g is one origin
node of the mesh, with its own items, buffers and overflow count.  Every
sort is stable, as `jnp.argsort` is, so the slot order within a
destination is the items' original order.  Overflowed items are counted
(`RoutePlan.dropped`), never scattered over surviving slots.
"""

from __future__ import annotations

import dataclasses

import torch


def run_ranks(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal keys, along the last
    axis.

    Args:
      sorted_keys: int [..., n], sorted ascending along the last axis
        (equal keys contiguous).
    Returns:
      int32 [..., n]; the j-th occurrence of a key gets rank j.
    """
    n = sorted_keys.shape[-1]
    dev = sorted_keys.device
    if n == 0:
        return torch.zeros(sorted_keys.shape, dtype=torch.int32, device=dev)
    pos = torch.arange(n, dtype=torch.int64, device=dev).expand(
        sorted_keys.shape)
    is_start = torch.ones(sorted_keys.shape, dtype=torch.bool, device=dev)
    is_start[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    run_start = torch.cummax(torch.where(is_start, pos, 0), dim=-1).values
    return (pos - run_start).to(torch.int32)


@dataclasses.dataclass
class RoutePlan:
    """Where each of F items of each of G groups goes in that group's
    [n_dests, cap] buffer.

    Per-item tensors are [G, F] in DESTINATION-SORTED order; `order` maps
    sorted position -> original index (`items.gather(1, order)` is the
    sorted view).
    """

    order: torch.Tensor    # int64 [G, F] sort permutation (by destination)
    dest: torch.Tensor     # int64 [G, F] destination (sorted; overflow -> 0)
    slot: torch.Tensor     # int64 [G, F] slot within dest (clamped to cap-1)
    ok: torch.Tensor       # bool  [G, F] item landed (slot < cap)
    dropped: torch.Tensor  # int32 [G] items that overflowed their dest


def plan_routes(dest: torch.Tensor, n_dests: int, cap: int) -> RoutePlan:
    """Assign each item a (dest, slot) in a capacitated per-dest buffer.

    `dest` is int [G, F].  Items beyond `cap` for a destination are
    marked not-ok and counted in `dropped`; their (dest, slot) are
    clamped so downstream gathers stay in bounds.
    """
    order = torch.argsort(dest, dim=-1, stable=True)
    d_sorted = dest.gather(-1, order).to(torch.int64)
    slot = run_ranks(d_sorted).to(torch.int64)
    ok = slot < cap
    return RoutePlan(
        order=order,
        dest=torch.where(ok, d_sorted, 0),
        slot=torch.where(ok, slot, cap - 1),
        ok=ok,
        dropped=(~ok).sum(dim=-1, dtype=torch.int32),
    )


def _groups(route: RoutePlan) -> torch.Tensor:
    g = route.order.shape[0]
    return torch.arange(g, device=route.order.device)[:, None].expand(
        route.order.shape)


def build_send_buffer(
    route: RoutePlan,
    n_dests: int,
    cap: int,
    values: torch.Tensor,  # [G, F, ...] per-item payload, ORIGINAL order
    fill,
) -> torch.Tensor:
    """Scatter per-item payloads into the [G, n_dests, cap, ...] send
    buffers.

    Empty slots hold `fill`, so receivers detect them by the fill
    sentinel of the metadata channel.  Only landed items are written:
    their (dest, slot) pairs are distinct, so no write races another.
    """
    idx = route.order.reshape(route.order.shape + (1,) * (values.dim() - 2))
    v_sorted = values.gather(1, idx.expand(route.order.shape
                                           + values.shape[2:]))
    buf = values.new_full((values.shape[0], n_dests, cap) + values.shape[2:],
                          fill)
    ok = route.ok
    buf[_groups(route)[ok], route.dest[ok], route.slot[ok]] = v_sorted[ok]
    return buf


def return_to_origin(
    route: RoutePlan,
    back: torch.Tensor,  # [G, n_dests, cap, ...] returned per-slot results
    fill,
) -> torch.Tensor:
    """Gather each item's result back out of the returned buffers.

    Returns [G, F, ...] in ORIGINAL item order; overflowed (dropped)
    items get `fill`.
    """
    shape = route.order.shape + back.shape[3:]
    if back.shape[2] == 0:
        # cap == 0: everything was dropped and there is no slot to read
        return back.new_full(shape, fill)
    grp = _groups(route)
    g = back[grp, route.dest, route.slot]                   # [G, F, ...]
    ok = route.ok.reshape(route.ok.shape + (1,) * (g.dim() - 2))
    g = torch.where(ok, g, torch.full_like(g, fill))
    out = torch.empty_like(g)
    out[grp, route.order] = g  # unsort: `order` is a permutation per group
    return out
