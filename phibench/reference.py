"""The plain reference of one PHI inference, in plain torch, written from
the semantics and sharing no code with the program.

From the panel (node codes and walks, as the benchmark made them) and the
sample's reads, it works out:
  * the read spectrum: the distinct minimizer keys of the reads. A k-mer's
    key is the smaller of the 2-bit codes of it and of its reverse
    complement (A < C < G < T), and a k-mer that holds an N has none; a
    window is w consecutive k-mers of one read, and its minimizer the
    smallest key among them, the rightmost on a tie;
  * each walk's minimizers: the windows of the walk's sequence whose key
    differs from the window before (the first window counts), and their
    join: those whose key is in the spectrum, each an occurrence on the
    walk's nodes from the node of its k-mer's first base to that of its
    last;
  * the threshold filter: occurrences are grouped by k-mer and the run of
    nodes they cover; a k-mer any of whose groups holds at least
    threshold x (number of walks) occurrences is dropped whole. What is
    left counts per walk (`anchors`); the occurrences over more than one
    node are the model's, and their distinct k-mers the model's k-mers;
  * the solve's bound: the least value, over paths through the lane
    states (walk, position), of R x switches - (model occurrences that lie
    inside one segment) + (model k-mers). A path starts at position 0 of
    a lane, moves along its lane for free, and switches, at cost R, from
    (lane, p) to (lane', q) where the walk's node at p and the node at q
    are joined by an edge and the lane's own next node is another (or the
    lane ends at p); it ends at the last position of a lane. This
    relaxation counts a k-mer once per occurrence inside a segment, so
    its least value is a lower bound of the exact objective;
  * a path's exact objective: R x switches - (distinct model k-mers with
    an occurrence inside one of its segments) + (model k-mers).
The DP runs in `dtype` (float64; the control runs it lower) as a plain
fixpoint: entries relaxed until no entry changes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phibench.synth import Panel, panel_edges

_INF = float("inf")


def canonical_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Keys of every k-mer along the last axis of int64 codes."""
    n = codes.shape[-1] - k + 1
    fwd = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.int64,
                      device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        c = codes[..., j:j + n]
        fwd = fwd * 4 + c
        rc = rc + ((3 - c) << (2 * j))
    return torch.minimum(fwd, rc)


def window_minimizers(keys: torch.Tensor, w: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(key, k-mer index) of the minimum of each window of w keys along
    the last axis, the rightmost on a tie."""
    nwin = keys.shape[-1] - w + 1
    best = keys[..., :nwin].clone()
    idx = torch.arange(nwin, device=keys.device).expand_as(best).clone()
    for j in range(1, w):
        cand = keys[..., j:j + nwin]
        take = cand <= best
        best = torch.where(take, cand, best)
        idx = torch.where(take, torch.arange(j, j + nwin,
                                             device=keys.device), idx)
    return best, idx


def read_spectrum(reads: np.ndarray, k: int, w: int, device,
                  block: int = 1 << 16) -> torch.Tensor:
    """Sorted distinct minimizer keys of the reads ([n, read_len] codes, 4
    an N). A k-mer that holds an N has no key; a window's minimizer is the
    smallest key among its k-mers that have one, and a window with none
    gives nothing."""
    parts = []
    dead_key = torch.iinfo(torch.int64).max
    for i in range(0, len(reads), block):
        codes = torch.from_numpy(reads[i:i + block]).to(device).long()
        is_n = (codes == 4).long()
        n_in = torch.nn.functional.pad(torch.cumsum(is_n, 1), (1, 0))
        dead = (n_in[:, k:] - n_in[:, :-k]) > 0
        keys = canonical_kmers(codes.clamp(max=3), k)
        keys = torch.where(dead, dead_key, keys)
        key, _ = window_minimizers(keys, w)
        parts.append(torch.unique(key[key != dead_key]))
    if not parts:
        return torch.zeros(0, dtype=torch.int64, device=device)
    return torch.unique(torch.cat(parts))


def walk_minimizers(codes: np.ndarray, k: int, w: int, device
                    ) -> tuple[int, torch.Tensor, torch.Tensor]:
    """(count, keys, k-mer start positions) of one walk's minimizers."""
    if len(codes) < k + w - 1:
        z = torch.zeros(0, dtype=torch.int64, device=device)
        return 0, z, z.clone()
    t = torch.from_numpy(codes).to(device).long()
    key, idx = window_minimizers(canonical_kmers(t, k), w)
    keep = torch.ones_like(key, dtype=torch.bool)
    keep[1:] = key[1:] != key[:-1]
    return int(keep.sum()), key[keep], idx[keep]


@dataclasses.dataclass
class PanelIndex:
    """What the reference derives from the panel alone, once per run."""

    walk_mat: torch.Tensor       # int64 [H, P] node ids, -1 past the end
    walk_len: torch.Tensor       # int64 [H]
    cum: list                    # per walk: int64 [len + 1] base offsets
    mins: list                   # per walk: (count, keys, positions)
    n_nodes: int
    edges: torch.Tensor          # int64 [E, 2]
    k: int
    w: int


def index_panel(panel: Panel, k: int, w: int, device) -> PanelIndex:
    H = panel.n_walks
    P = max(len(x) for x in panel.walks)
    wm = torch.full((H, P), -1, dtype=torch.int64)
    for h, walk in enumerate(panel.walks):
        wm[h, :len(walk)] = torch.from_numpy(walk.astype(np.int64))
    node_len = panel.node_len
    cum, mins = [], []
    for h, walk in enumerate(panel.walks):
        c = np.zeros(len(walk) + 1, np.int64)
        np.cumsum(node_len[walk], out=c[1:])
        cum.append(torch.from_numpy(c).to(device))
        mins.append(walk_minimizers(panel.walk_codes(h), k, w, device))
    return PanelIndex(
        walk_mat=wm.to(device),
        walk_len=torch.tensor([len(x) for x in panel.walks],
                              dtype=torch.int64, device=device),
        cum=cum, mins=mins, n_nodes=len(panel.node_off) - 1,
        edges=torch.from_numpy(panel_edges(panel)).to(device), k=k, w=w)


@dataclasses.dataclass
class Anchors:
    spectrum_size: int
    minimizers: list[int]
    anchors: list[int]
    filtered: int
    model_kmers: int
    occ_hap: torch.Tensor        # model occurrences (span > 0)
    occ_s: torch.Tensor
    occ_e: torch.Tensor
    occ_kid: torch.Tensor


def _dense_rank(x: torch.Tensor) -> torch.Tensor:
    return torch.unique(x, return_inverse=True)[1]


def anchors(pi: PanelIndex, spectrum: torch.Tensor, threshold: float
            ) -> Anchors:
    """The join of every walk's minimizers against the spectrum, and the
    threshold filter."""
    dev = spectrum.device
    H = len(pi.mins)
    haps, ss, es, kids = [], [], [], []
    for h, (_, key, pos) in enumerate(pi.mins):
        if len(spectrum) == 0 or len(key) == 0:
            continue
        i = torch.searchsorted(spectrum, key)
        hit = spectrum[i.clamp(max=len(spectrum) - 1)] == key
        p = pos[hit]
        s = torch.searchsorted(pi.cum[h], p, right=True) - 1
        e = torch.searchsorted(pi.cum[h], p + pi.k - 1, right=True) - 1
        haps.append(torch.full_like(p, h))
        ss.append(s)
        es.append(e)
        kids.append(i[hit])
    z = torch.zeros(0, dtype=torch.int64, device=dev)
    hap, s, e, kid = (torch.cat(x) if x else z for x in (haps, ss, es, kids))
    # group by (k-mer, node run): a dense rank extended one node at a time
    span = e - s
    rank = _dense_rank(kid * (int(span.max()) + 1 if len(span) else 1)
                       + span)
    for j in range(int(span.max()) + 1 if len(span) else 0):
        node = torch.where(span >= j, pi.walk_mat[hap, (s + j).clamp(
            max=pi.walk_mat.shape[1] - 1)], -1)
        rank = _dense_rank(rank * (pi.n_nodes + 1) + node + 1)
    counts = torch.bincount(rank)
    bad_occ = counts[rank].double() >= threshold * H
    bad = torch.unique(kid[bad_occ])
    keep = ~torch.isin(kid, bad)
    model = keep & (e > s)
    return Anchors(
        spectrum_size=len(spectrum),
        minimizers=[m[0] for m in pi.mins],
        anchors=torch.bincount(hap[keep], minlength=H).tolist(),
        filtered=len(bad),
        model_kmers=len(torch.unique(kid[model])),
        occ_hap=hap[model], occ_s=s[model], occ_e=e[model],
        occ_kid=kid[model])


def _prefix(H: int, P: int, idx_h, idx_p, val, dtype, dev) -> torch.Tensor:
    """[H, P] running sums along p of val scattered at (idx_h, idx_p);
    indices at P or past it are dropped."""
    grid = torch.zeros(H * (P + 1), dtype=dtype, device=dev)
    ok = idx_p < P
    grid.index_put_((idx_h[ok] * (P + 1) + idx_p[ok],), val[ok].to(dtype),
                    accumulate=True)
    return torch.cumsum(grid.view(H, P + 1)[:, :P], 1, dtype=dtype)


def switch_sources(pi: PanelIndex) -> tuple[torch.Tensor, torch.Tensor]:
    """(flat lane state h * P + p, target node) of every switch: from a
    state at node u along each edge (u, v) whose v is not the lane's next
    node."""
    wm, wl = pi.walk_mat, pi.walk_len
    H, P = wm.shape
    dev = wm.device
    u_e, v_e = pi.edges[:, 0], pi.edges[:, 1]
    order = torch.argsort(u_e, stable=True)
    u_e, v_e = u_e[order], v_e[order]
    deg = torch.bincount(u_e, minlength=pi.n_nodes)
    first = torch.cumsum(deg, 0) - deg
    nxt = torch.full_like(wm, -1)
    nxt[:, :-1] = wm[:, 1:]
    flat = torch.arange(H * P, device=dev).view(H, P)
    valid = torch.arange(P, device=dev)[None, :] < wl[:, None]
    u = wm.clamp(min=0)
    cand = valid & ((deg[u] >= 2) | ((nxt < 0) & (deg[u] >= 1)))
    st, uu, nx = flat[cand], u[cand], nxt[cand]
    d = deg[uu]
    rep = torch.repeat_interleave(torch.arange(len(st), device=dev), d)
    within = torch.arange(len(rep), device=dev) - torch.repeat_interleave(
        torch.cumsum(d, 0) - d, d)
    v = v_e[first[uu[rep]] + within]
    div = v != nx[rep]
    return st[rep][div], v[div]


def relaxed_bound(pi: PanelIndex, an: Anchors, R: float, dtype,
                  sources=None, max_sweeps: int = 100_000) -> float:
    """The least relaxed objective over paths (module docstring)."""
    wm, wl = pi.walk_mat, pi.walk_len
    H, P = wm.shape
    dev = wm.device
    one = torch.ones(len(an.occ_hap), dtype=dtype, device=dev)
    Sc = _prefix(H, P, an.occ_hap, an.occ_s + 1, one, dtype, dev)
    Bc = _prefix(H, P, an.occ_hap, an.occ_e, one, dtype, dev)
    maxspan = int((an.occ_e - an.occ_s).max()) if len(an.occ_hap) else 1
    straddle = []
    for j in range(maxspan - 1):
        # occurrences with s < p - j and p < e
        lo = an.occ_s + j + 1
        ok = lo < an.occ_e
        h = an.occ_hap[ok]
        up = _prefix(H, P, h, lo[ok], one[ok], dtype, dev)
        dn = _prefix(H, P, h, an.occ_e[ok], one[ok], dtype, dev)
        straddle.append(up - dn)
    valid = torch.arange(P, device=dev)[None, :] < wl[:, None]
    inf = torch.tensor(_INF, dtype=dtype, device=dev)
    src, tgt = sources if sources is not None else switch_sources(pi)
    node = wm.clamp(min=0)
    Rt = torch.tensor(R, dtype=dtype, device=dev)

    def shift(x, j):
        if j == 0:
            return x
        return torch.cat([inf.expand(H, j), x[:, :-j]], 1)

    ent = torch.full((H, P), _INF, dtype=dtype, device=dev)
    ent[:, 0] = 0
    ent = torch.where(valid, ent, inf)
    for _ in range(max_sweeps):
        G = ent + Sc
        best = shift(torch.cummin(G, 1).values, maxspan - 1)
        for j in range(maxspan - 1):
            best = torch.minimum(best, shift(G, j) - straddle[j])
        F = torch.where(valid, best - Bc, inf)
        exit_ = torch.full((pi.n_nodes,), _INF, dtype=dtype, device=dev)
        exit_.scatter_reduce_(0, tgt, F.view(-1)[src], "amin")
        new = Rt + exit_[node]
        new[:, 0] = torch.minimum(new[:, 0], torch.zeros_like(new[:, 0]))
        new = torch.where(valid, new, inf)
        if torch.equal(new, ent):
            break
        ent = new
    else:
        raise RuntimeError("the reference DP did not converge")
    ends = F[torch.arange(H, device=dev), (wl - 1).clamp(min=0)]
    const = torch.tensor(float(an.model_kmers), dtype=dtype, device=dev)
    return float((ends.min() + const).item())


def path_objective(an: Anchors, segments, R: float, dtype=torch.float64
                   ) -> float:
    """Exact objective of a path given as (lane, first, last) segments."""
    covered = torch.zeros(len(an.occ_hap), dtype=torch.bool,
                          device=an.occ_hap.device)
    for h, q, p in segments:
        covered |= (an.occ_hap == h) & (an.occ_s >= q) & (an.occ_e <= p)
    n_cov = len(torch.unique(an.occ_kid[covered]))
    R_, switches, model, cov = (
        torch.tensor(float(x), dtype=dtype, device=an.occ_hap.device)
        for x in (R, len(segments) - 1, an.model_kmers, n_cov))
    return float((R_ * switches + model - cov).item())


def path_faults(pi: PanelIndex, segments) -> int:
    """How many rules the path breaks: it starts at a lane's first
    position, ends at a lane's last, and each switch follows an edge off
    the lane's own next node."""
    wm = pi.walk_mat.cpu().numpy()
    wl = pi.walk_len.cpu().numpy()
    edges = set(map(tuple, pi.edges.cpu().numpy().tolist()))
    if not segments:
        return 1
    bad = int(segments[0][1] != 0)
    bad += int(segments[-1][2] != wl[segments[-1][0]] - 1)
    for h, q, p in segments:
        bad += int(not 0 <= q <= p < wl[h])
    for (h1, _, p1), (h2, q2, _) in zip(segments, segments[1:]):
        u, v = int(wm[h1, p1]), int(wm[h2, q2])
        nxt = int(wm[h1, p1 + 1]) if p1 + 1 < wl[h1] else -1
        bad += int((u, v) not in edges or nxt == v)
    return bad


def path_sequence(panel: Panel, segments) -> np.ndarray:
    """Base codes of the path's nodes."""
    from phibench.synth import gather_nodes
    nodes = np.concatenate([panel.walks[h][q:p + 1] for h, q, p in segments])
    return gather_nodes(panel.node_codes, panel.node_off, nodes)


def path_report(panel: Panel, segments) -> tuple[int, list[str]]:
    """PHI's recombination report of a path: the count of changes of lane
    name along its nodes, and one `>(name,[lo,hi])` a run of one lane,
    where lo counts the bases through the run's first node (0 for the
    first run) and hi is one less than the next run's lo (the last run
    ends at the path's last base)."""
    names = panel.walk_names()
    labels = np.concatenate([np.full(p - q + 1, h) for h, q, p in segments])
    nodes = np.concatenate([panel.walks[h][q:p + 1] for h, q, p in segments])
    through = np.cumsum(panel.node_len[nodes])
    total = int(through[-1])
    starts = [0] + (np.flatnonzero(labels[1:] != labels[:-1]) + 1).tolist()
    if len(starts) == 1:
        return 0, [f">({names[int(labels[0])]},[0,{total - 1}])"]
    lo = [0] + [int(through[i]) for i in starts[1:]]
    hi = [x - 1 for x in lo[1:]] + [total - 1]
    return len(starts) - 1, [f">({names[int(labels[i])]},[{a},{b}])"
                             for i, a, b in zip(starts, lo, hi)]


def read_fasta(path: str) -> tuple[str, np.ndarray]:
    """(header line, base codes) of a one-record FASTA."""
    with open(path, "rb") as f:
        head = f.readline().decode().rstrip("\n")
        body = f.read().replace(b"\n", b"")
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    return head, lut[np.frombuffer(body, np.uint8)]
