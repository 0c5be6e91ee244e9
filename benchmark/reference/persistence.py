"""Exact Vietoris-Rips H0 / H1 diagrams for the benchmark's reference.

A frozen copy of the port's plain PyTorch reduction (edge ranks, spanning
forest, apparent-pair sieve, cohomology reduction of the non-apparent
creators over GF(2), all windows in lockstep), kept here so that later
changes to the program cannot change the yardstick.  Two departures from
the program's copy: the distances keep their dtype (float64 in the
reference), and a window whose creators or bars overflow the dense arena is
redone by the boundary-matrix reduction of `oracle.py`.  Imports nothing
of the program.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import oracle

BIG = 2_000_000_000
ESSENTIAL = -2      # pair key of a creator whose column reduced to zero


@functools.lru_cache(maxsize=None)
def static_tables(n: int):
    iu, ju = np.triu_indices(n, k=1)
    m = len(iu)
    edge_id = np.full((n, n), m, np.int64)  # m = sentinel (diag)
    edge_id[iu, ju] = np.arange(m)
    edge_id[ju, iu] = np.arange(m)
    return dict(iu=iu.astype(np.int64), ju=ju.astype(np.int64), m=m,
                flat_ut=(iu * n + ju).astype(np.int64),
                edge_id_flat=edge_id.reshape(-1))


def _boruvka_forest(key_mat: torch.Tensor) -> torch.Tensor:
    """Minimum spanning forest over a strict-order key matrix (BIG = absent).

    key_mat: (B, n, n) int32, symmetric.  Returns the (B, n, n) bool tree
    matrix.  Ranks are a strict total order, so the forest is unique (the
    Kruskal-by-rank forest); each of ⌈log2 n⌉ rounds hooks every component
    onto its cheapest outgoing edge, mutual 2-cycles keep the smaller label,
    and pointer jumping compresses the labels."""
    B, n, _ = key_mat.shape
    dev = key_mat.device
    vr = torch.arange(n, device=dev)
    label = vr.expand(B, n).clone()
    tree = torch.zeros((B, n, n), dtype=torch.bool, device=dev)
    n_rounds = max(int(math.ceil(math.log2(max(n, 2)))), 1)
    for _ in range(n_rounds):
        cross = label[:, :, None] != label[:, None, :]
        km = torch.where(cross, key_mat, BIG)
        row_min, row_arg = km.min(dim=2)
        same = ~cross
        comp_min = torch.where(same, row_min[:, None, :], BIG).amin(dim=2)
        att = same & (row_min[:, None, :] == comp_min[:, :, None]) \
            & (comp_min[:, :, None] < BIG)
        win_v = torch.where(att, vr, n).amin(dim=2)
        is_winner = (vr[None, :] == win_v) & (row_min < BIG)
        upd = is_winner[:, :, None] & (vr[None, None, :] == row_arg[:, :, None])
        tree = tree | upd | upd.transpose(1, 2)
        tgt_label = label.gather(1, row_arg)
        win_safe = win_v.clamp(max=n - 1)
        parent = torch.where(comp_min < BIG, tgt_label.gather(1, win_safe), label)
        back = parent.gather(1, parent)
        parent = torch.where((back == label) & (parent > label), label, parent)
        label = parent
        for _ in range(n_rounds):
            label = label.gather(1, label)
    return tree


def _phase1(dm: torch.Tensor, n: int, thresh: float, na_max: int, n_pts=None):
    """Edge ranks, spanning forest, apparent-pairs sieve, H0 bars, creators.

    Enclosing-radius truncation: every visible H1 bar is born and dies at
    weights ≤ r_enc = min_i max_j d(i, j) over valid points, so the complex
    is cut at min(thresh, r_enc) — exact for the visible diagram.
    n_pts: (B,) valid-point counts (points padded at the end), or None.

    Ties in float32 weights are broken by static edge order through a
    stable sort, exactly as the reference's stable payload sort.  The four
    parts (`_edge_ranks`, `_boruvka_forest`, `_sieve`, `_compact`) are
    timed one by one by `tools/h1_kernel_profile.py`; the CUDA kernel
    `phase1_cuda` computes the whole."""
    rk = _edge_ranks(dm, n, thresh, n_pts)
    tree_mat = _boruvka_forest(rk["key_mat"])
    vstar_static = _sieve(rk["rank_mat"], rk["e_rank"], n)
    return _compact(rk, tree_mat, vstar_static, n, na_max)


def _edge_ranks(dm: torch.Tensor, n: int, thresh: float, n_pts=None):
    """The enclosing-radius cut m_cx, the stable edge sort (ew_r, e_sort),
    the static → rank scatter e_rank, the rank matrix (BIG on the diagonal)
    and the forest's key matrix (BIG outside the complex)."""
    st = static_tables(n)
    m = st["m"]
    dev = dm.device
    flat_ut = torch.as_tensor(st["flat_ut"], device=dev)
    edge_id_flat = torch.as_tensor(st["edge_id_flat"], device=dev)
    B = dm.shape[0]

    vr = torch.arange(n, device=dev)
    if n_pts is None:
        valid = torch.ones((B, n), dtype=torch.bool, device=dev)
    else:
        valid = vr[None, :] < n_pts.to(dev)[:, None]
    vv = valid[:, :, None] & valid[:, None, :]
    row_max = torch.where(vv, dm, -math.inf).amax(dim=-1)
    r_enc = torch.where(valid, row_max, math.inf).amin(dim=-1)
    thresh32 = torch.tensor(thresh, dtype=dm.dtype, device=dev)
    eff_thresh = torch.minimum(thresh32,
                               torch.where(torch.isfinite(r_enc), r_enc, thresh32))

    w = dm.reshape(B, n * n)[:, flat_ut]                              # (B, m)
    # every NaN sorts as the one +NaN, last on every device (the card's sort
    # puts a NaN with its sign bit first); ew_r keeps the input's bits
    key = torch.where(w.isnan(), math.nan, w)
    e_sort = torch.sort(key, dim=-1, stable=True).indices             # by rank
    ew_r = w.gather(1, e_sort)
    iota_m = torch.arange(m, device=dev)
    e_rank = torch.empty_like(e_sort).scatter_(1, e_sort, iota_m.expand(B, m))
    m_cx = (ew_r <= eff_thresh[:, None]).sum(dim=-1)

    e_rank_pad = torch.cat([e_rank, torch.full((B, 1), BIG, dtype=e_rank.dtype,
                                                device=dev)], dim=-1)
    rank_mat = e_rank_pad[:, edge_id_flat].reshape(B, n, n).to(torch.int32)
    key_mat = torch.where(rank_mat < m_cx[:, None, None].to(torch.int32),
                          rank_mat, BIG)
    return dict(ew_r=ew_r, e_sort=e_sort, e_rank=e_rank, m_cx=m_cx,
                rank_mat=rank_mat, key_mat=key_mat)


def _sieve(rank_mat: torch.Tensor, e_rank: torch.Tensor, n: int):
    """Apparent sieve: edge e apparent iff ∃v with both cross ranks <
    rank(e); its partner triangle is (rank(e), first such v).  Returns the
    first v per static edge, −1 where none."""
    st = static_tables(n)
    dev = rank_mat.device
    iu = torch.as_tensor(st["iu"], device=dev)
    ju = torch.as_tensor(st["ju"], device=dev)
    vr = torch.arange(n, device=dev)
    r_e = e_rank.to(torch.int32)[:, :, None]
    both = (rank_mat[:, iu, :] < r_e) & (rank_mat[:, ju, :] < r_e)  # (B, m, n)
    vstar_static = torch.where(both, vr.to(torch.int32), n).amin(dim=-1)
    return torch.where(vstar_static < n, vstar_static, -1)


def _compact(rk: dict, tree_mat: torch.Tensor, vstar_static: torch.Tensor,
             n: int, na_max: int):
    """Static order → rank order, H0 deaths and the creator list: the dict
    of `_phase1`."""
    st = static_tables(n)
    m = st["m"]
    dev = tree_mat.device
    iu = torch.as_tensor(st["iu"], device=dev)
    ju = torch.as_tensor(st["ju"], device=dev)
    flat_ut = torch.as_tensor(st["flat_ut"], device=dev)
    B = tree_mat.shape[0]
    ew_r, e_sort, m_cx = rk["ew_r"], rk["e_sort"], rk["m_cx"]
    iota_m = torch.arange(m, device=dev)
    in_cx_r = iota_m[None, :] < m_cx[:, None]
    tree_static = tree_mat.reshape(B, n * n)[:, flat_ut]

    tree_r = tree_static.gather(1, e_sort)
    vstar_r = vstar_static.gather(1, e_sort)
    iu_r = iu[e_sort]
    ju_r = ju[e_sort]
    positive_r = ~tree_r & in_cx_r
    apparent_r = (vstar_r >= 0) & positive_r

    tree_cx = tree_r & in_cx_r
    # stable, as jnp.sort: tied weights (-0.0 beside +0.0) keep rank order
    h0_deaths = torch.sort(torch.where(tree_cx, ew_r, math.inf), dim=-1,
                           stable=True).values[:, : n - 1]
    h0_mask = torch.isfinite(h0_deaths) & (h0_deaths > 0.0)
    n_tree = tree_cx.sum(dim=-1)

    na_mask = positive_r & ~apparent_r
    na_key = torch.where(na_mask, iota_m, -1)
    na_list = torch.sort(na_key, dim=-1, descending=True).values[:, :na_max]
    overflow_na = na_mask.sum(dim=-1) > na_max
    return dict(m=m, m_cx=m_cx.to(torch.int32), ew_r=ew_r,
                rank_mat=rk["rank_mat"], iu_r=iu_r.to(torch.int32),
                ju_r=ju_r.to(torch.int32), vstar_r=vstar_r.to(torch.int32),
                apparent_r=apparent_r, na_list=na_list.to(torch.int32),
                overflow_na=overflow_na, h0_deaths=h0_deaths, h0_mask=h0_mask,
                n_tree=n_tree.to(torch.int32))


def reduction_inputs(ph):
    """The reduction's operands, int32 and contiguous: rank matrix (B, n, n),
    edge endpoints by rank iu_r/ju_r (B, m), app_v (B, m) = the apparent
    partner vertex of each edge (−1 if the edge is not apparent), the
    creator list (B, na) and the in-complex edge counts m_cx (B,)."""
    app_v = torch.where(ph["apparent_r"], ph["vstar_r"], -1).to(torch.int32)
    return [t.contiguous() for t in (ph["rank_mat"], ph["iu_r"], ph["ju_r"],
                                      app_v, ph["na_list"], ph["m_cx"])]


def _cobd_keys(g, rank_mat, iu_r, ju_r, m_cx, n, none_key):
    """(B,) edge ranks → (B, n) keys of the in-complex cofacets, none_key
    where vertex v gives no cofacet.  Cofacet (i, j, v) has max-edge rank
    gmax = max(g, rank(i,v), rank(j,v)) and opposite vertex j, i or v
    according to which edge attains it (ranks are distinct)."""
    bi = torch.arange(g.shape[0], device=g.device)
    i_g = iu_r[bi, g].long()
    j_g = ju_r[bi, g].long()
    row_i = rank_mat[bi, i_g].long()                                  # (B, n)
    row_j = rank_mat[bi, j_g].long()
    gmax = torch.maximum(g[:, None], torch.maximum(row_i, row_j))
    valid = gmax < m_cx[:, None]
    vr = torch.arange(n, device=g.device)
    opp = torch.where(gmax == row_i, j_g[:, None],
                      torch.where(gmax == row_j, i_g[:, None], vr[None, :]))
    return torch.where(valid, gmax * n + opp, none_key)


def reduce_plain(rank_mat, iu_r, ju_r, app_v, na_list, m_cx, n: int,
                 step_budget: int, word_ops=None):
    """Plain PyTorch cohomology reduction, all windows in lockstep.

    A column is a dense bool vector over the m·n triangle keys (plus one
    spare slot that absorbs non-cofacets).  Each step, per active window:
    pivot p = smallest set key; if p is (g, vstar(g)) of an apparent edge g
    the column is XORed with cobd(g); else if a finished column holds pivot
    p it is XORed with that column; else the column finishes — its pair key
    is p (ESSENTIAL when the column is zero), it is stored, and the next
    creator's coboundary is loaded.  A window that is still active after
    `step_budget` steps is flagged.

    Returns (pair_key (B, na) int32: key, ESSENTIAL or −1 when never
    finished; steps (B,) int32 per-window step count; overflow (B,) bool).

    word_ops, if given, is a (B,) int64 tensor to which each window's
    least work in 32-bit column words is added (the work a performance
    bound counts, in the dense g·n + v key layout): n for every coboundary
    XOR (a creator's load or an apparent step), and the words from the
    pivot's word to ⌈m_cx·n/32⌉ for a stored-column XOR or a store.
    """
    B, na = na_list.shape
    dev = na_list.device
    m = iu_r.shape[1]
    KS = m * n
    bi = torch.arange(B, device=dev)
    iota_na = torch.arange(na, device=dev)
    m_cx_l = m_cx.long()

    def cobd(g):
        keys = _cobd_keys(g, rank_mat, iu_r, ju_r, m_cx_l, n, KS)
        cob = torch.zeros((B, KS + 1), dtype=torch.bool, device=dev)
        cob.scatter_(1, keys, True)
        cob[:, KS] = False
        return cob

    pair = torch.full((B, na), -1, dtype=torch.int32, device=dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    cur = torch.zeros(B, dtype=torch.long, device=dev)
    stored = torch.zeros((B, na, KS + 1), dtype=torch.bool, device=dev)
    first = na_list[:, 0].long()
    active = first >= 0
    col = cobd(first.clamp(min=0)) & active[:, None]
    if word_ops is not None:
        hi = (m_cx_l * n + 31) // 32
        word_ops += n * active.long()
    for it in range(step_budget):
        # a finished window is a fixed point of the step, so the look
        # (a host synchronisation) need not come every step
        if it % 32 == 0 and not bool(active.any()):
            break
        # the pivot: the first set key (argmax returns the first maximum);
        # the spare slot KS is never set
        first_set = col.view(torch.uint8).argmax(dim=-1)
        nonzero = col.gather(1, first_set[:, None]).squeeze(1)
        p = torch.where(nonzero, first_set, KS)
        ps = torch.where(nonzero, p, 0)
        g = ps // n
        v = ps - g * n
        own_app = nonzero & (app_v[bi, g].long() == v)
        hit = (pair.long() == p[:, None]) & nonzero[:, None]
        slot = torch.where(hit, iota_na, na).amin(dim=-1)
        own_na = (slot < na) & ~own_app
        claimed = own_app | own_na
        do_xor = active & claimed
        finish = active & ~claimed
        steps += active.to(torch.int32)

        sel_cur = (iota_na[None, :] == cur[:, None]) & finish[:, None]
        pair = torch.where(sel_cur, torch.where(nonzero, p, ESSENTIAL)
                           .to(torch.int32)[:, None], pair)
        # every window's column goes to its own slot: a slot is read only
        # once its pair is set, by the step that finishes it, so the last
        # write is the finished column (a done window's writes are never read)
        stored[bi, cur.clamp(max=na - 1)] = col

        nxt_cur = cur + finish.long()
        nxt_edge = na_list[bi, nxt_cur.clamp(max=na - 1)].long()
        still = finish & (nxt_cur < na) & (nxt_edge >= 0)
        if word_ops is not None:
            tail = hi - p // 32
            word_ops += torch.where(do_xor & own_app, n, 0) + n * still.long()
            word_ops += torch.where((do_xor & ~own_app) | (finish & nonzero),
                                    tail, 0)
        cob = cobd(torch.where(do_xor & own_app, g, nxt_edge.clamp(min=0)))
        stc = stored[bi, slot.clamp(max=na - 1)]
        operand = torch.where(own_app[:, None], cob, stc)
        col = torch.where((do_xor)[:, None], col ^ operand,
                          torch.where(still[:, None], cob,
                                      col & ~finish[:, None]))
        cur = nxt_cur
        active = torch.where(finish, still, active)
    return pair, steps, active


def _extract_bars(pair_key, steps, overflow_steps, ph, n: int, h1_max: int):
    """Pair keys → the h1_diagrams return contract: births/deaths/mask
    (B, h1_max), n_essential, overflow, h0_deaths/h0_mask/n_tree, steps
    (B,) per window, n_na.  Apparent pairs are never visible."""
    na_list = ph["na_list"].long()
    ew_r = ph["ew_r"]
    na_eff = na_list.shape[1]
    pk = pair_key.long()
    births = ew_r.gather(1, na_list.clamp(min=0))
    deaths = ew_r.gather(1, pk.clamp(min=0) // n)
    ess = (pk == ESSENTIAL) & (na_list >= 0)
    deaths = torch.where(ess, math.inf, deaths)
    vis = (na_list >= 0) & ((pk >= 0) | ess) & (deaths > births)

    order = torch.argsort((~vis).to(torch.uint8), dim=-1, stable=True)[:, :h1_max]
    births = births.gather(1, order)
    deaths = deaths.gather(1, order)
    mask = vis.gather(1, order)
    if h1_max > na_eff:
        pad = h1_max - na_eff
        births = torch.nn.functional.pad(births, (0, pad))
        deaths = torch.nn.functional.pad(deaths, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    n_essential = ess.sum(dim=-1).to(torch.int32)
    overflow = ph["overflow_na"] | overflow_steps | (vis.sum(dim=-1) > h1_max)
    return dict(births=births, deaths=deaths, mask=mask,
                n_essential=n_essential, overflow=overflow,
                h0_deaths=ph["h0_deaths"], h0_mask=ph["h0_mask"],
                n_tree=ph["n_tree"], steps=steps,
                n_na=(na_list >= 0).sum(dim=-1).to(torch.int32))


NA_MAX = 128
H1_MAX = 128


def _cat(parts):
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0] if torch.is_tensor(parts[0][k])}


def diagrams(dm: torch.Tensor, n_pts=None, thresh: float = 2.0,
             step_budget: int = 1 << 20):
    """(B, n, n) distances (padding points > thresh) → dict of tensors on
    dm's device: h0_deaths (B, n - 1) ascending (inf past the forest),
    h0_mask (finite and > 0), n_tree (B,), births / deaths (B, H1_MAX) of
    the visible H1 bars first (deaths inf for essential classes), mask,
    n_essential (B,), steps and n_na (B,).  Exact for every window:
    overflowed windows are redone on the host.

    The lockstep reduction runs until the slowest window of a chunk is
    done, so the windows are chunked in order of their creator counts, and
    each chunk's columns stop at its largest complex (keys g·n + v with
    g < m_cx) and its store of finished columns at its most creators."""
    B, n, _ = dm.shape
    m = n * (n - 1) // 2
    on_card = dm.is_cuda
    piece = max(1, ((1 << 30) if on_card else (1 << 26)) // (m * n))
    ph = _cat([_phase1(dm[c:c + piece], n, thresh, NA_MAX,
                       None if n_pts is None else n_pts[c:c + piece])
               for c in range(0, B, piece)])
    n_na = (ph["na_list"] >= 0).sum(dim=-1)
    order = torch.argsort(n_na, descending=True, stable=True)
    counts = n_na[order].tolist()
    budget = (1 << 33) if on_card else (1 << 27)
    outs = []
    c = 0
    while c < B:
        # the chunk's stored columns are (windows, creators, m·n + 1) bools,
        # its first window the one with the most creators
        na_c = max(1, counts[c])
        ids = order[c:c + max(1, budget // (na_c * (m * n + 1)))]
        c += len(ids)
        sub = {k: v[ids] for k, v in ph.items()}
        sub["na_list"] = sub["na_list"][:, :na_c]
        rank_mat, iu_r, ju_r, app_v, na_list, m_cx = reduction_inputs(sub)
        mc = max(int(m_cx.max()), 1)
        pair, steps, ovf = reduce_plain(rank_mat, iu_r[:, :mc].contiguous(),
                                        ju_r[:, :mc].contiguous(), app_v[:, :mc].contiguous(),
                                        na_list, m_cx, n=n, step_budget=step_budget)
        outs.append(_extract_bars(pair, steps, ovf, sub, n, H1_MAX))
    out = _cat(outs)
    back = torch.argsort(order)
    out = {k: v[back] for k, v in out.items()}
    bad = torch.nonzero(out["overflow"]).squeeze(1).tolist()
    for w in bad:
        k = n if n_pts is None else int(n_pts[w])
        h0, h1 = oracle.rips_persistence_dm(
            dm[w, :k, :k].double().cpu().numpy(), maxdim=1, thresh=thresh)
        fin0 = np.sort(h0[np.isfinite(h0[:, 1]), 1])
        if len(h1) > H1_MAX:
            raise RuntimeError(f"{len(h1)} H1 bars in one window")
        dev, dt = dm.device, out["births"].dtype
        out["births"][w] = 0.0
        out["deaths"][w] = 0.0
        out["mask"][w] = False
        out["births"][w, :len(h1)] = torch.as_tensor(h1[:, 0], dtype=dt, device=dev)
        out["deaths"][w, :len(h1)] = torch.as_tensor(h1[:, 1], dtype=dt, device=dev)
        out["mask"][w, :len(h1)] = True
        out["n_essential"][w] = int(np.isinf(h1[:, 1]).sum())
        full = np.full(n - 1, np.inf)
        n_tree = k - int(np.isinf(h0[:, 1]).sum())
        full[:n_tree] = np.concatenate([np.zeros(n_tree - len(fin0)), fin0])
        out["h0_deaths"][w] = torch.as_tensor(full, dtype=dt, device=dev)
        out["h0_mask"][w] = torch.as_tensor(np.isfinite(full) & (full > 0), device=dev)
        out["n_tree"][w] = n_tree
    out["redone"] = len(bad)
    return out
