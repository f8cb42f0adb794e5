"""Device-side lexical rerank: BM25 over per-row term fingerprints.

Counterpart of ``semcode_tpu/index/lexical.py``. The ingest side is a copy
of the reference (host featurization of identifier-aware, field-boosted
term statistics into a fixed-width fingerprint per row: the top ``kterms``
terms by selection weight as crc32 ids with f16 tf weights, plus the doc's
total term mass and its whole-symbol hash). The query side runs on the
device: gather the candidate window's fingerprints by global row id from
the row-sharded fingerprint table (each shard gathers the rows in its
range from its own tensors and the parts are summed, the reference's psum),
window-level
BM25 with the exact-symbol bonus and the gated learned MaxSim channel, the
min-max blend with the dense scores, and the stable two-key sort — the
math of ``bm25_blend`` (lexical.py:269-377), chunked by query so the
(Q, W, K, T) match tensor stays a few tens of MB.
"""

from __future__ import annotations

import threading
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from ..parallel.mesh import (
    Mesh,
    ShardedRows,
    all_reduce_sum,
    local_shards,
    n_shards,
    resolve_mesh,
)
from ..embeddings.hash_embedder import STOP_TOKENS as _STOP_TOKENS
from .rerank import (
    DEFAULT_SYM_BONUS,
    MAX_SYM_CANDIDATES,
    _doc_tf_uncached,
    normalize_symbol,
    query_symbol_candidates,
    tokenize,
)

_K1 = np.float32(1.2)
_B = np.float32(0.75)
_NEG_INF = np.float32(-3.0e38)

# fingerprint width: top-K terms by selection weight. Lab measurement
# (tools/rerank_lab.py, held-out corpora, saturated+stop-factor
# selection): K=320 matches the untruncated host BM25 EXACTLY on both
# corpora; K=256 is within 0.005 MRR (aiohttp 0.7306 vs host 0.7352 at
# depth 10; reference exact parity) at 1.5 GB HBM per 1M rows (int32 id +
# f16 weight), gathered only for the candidate window. K=192 -> -0.023 on
# aiohttp, K=64 -> -0.10: a 6000-char code chunk carries 200+ unique
# subtokens and docstring queries hit the tail.
DEFAULT_KTERMS = 256
QUERY_TERMS = 64
# learned-channel doc-term head (keep equal to term_reranker.DOC_TERMS)
_LEARNED_DOC_TERMS = 96
# exact-symbol bonus (defined next to the host scorer so both impls share
# one default): +0.03-0.05 held-out MRR, see rerank.DEFAULT_SYM_BONUS


def term_hash(tok: str) -> int:
    """Stable 31-bit term id (crc32; python hash() is salted per process)."""
    return zlib.crc32(tok.encode("utf-8")) & 0x7FFFFFFF


class _HitShim:
    """Adapter so rerank._doc_tf_uncached's hit interface works on raw
    payload fields (text/symbol/path) at ingest time."""

    __slots__ = ("text", "metadata", "path", "id")

    def __init__(self, text, symbol, path):
        self.text = text
        self.metadata = {"symbol": symbol} if symbol else {}
        self.path = path
        self.id = None


def _selection_weight(tok: str, tf: float) -> float:
    """Which terms deserve a fingerprint slot? NOT raw tf — BM25 saturates
    tf at (k1+1), so a rare tf=1 term contributes nearly as much as a
    tf=20 one when a query asks for it, and rare terms are exactly what
    queries discriminate on. Selection key = saturated tf, downweighted
    for the stop list (keywords/english glue: `self`/`return`/`the` have
    huge tf in code chunks but near-zero query idf) and for very short
    tokens (generic). Measured on the held-out lab (tools/rerank_lab.py):
    raw-tf selection at K=64 loses 0.08 MRR vs the untruncated host
    scorer on docstring queries; this selection closes most of that."""
    sat = tf * (float(_K1) + 1.0) / (tf + float(_K1))
    if tok in _STOP_TOKENS or tok.isdigit():
        sat *= 0.3
    if len(tok) <= 2:
        sat *= 0.6
    return sat


def featurize_doc(
    text: Optional[str],
    symbol: Optional[str] = None,
    path: Optional[str] = None,
    *,
    kterms: int = DEFAULT_KTERMS,
) -> Tuple[np.ndarray, np.ndarray, np.float32]:
    """-> (term ids int32 (kterms,), weights f16 (kterms,), total length).

    Padding slots carry id -1 / weight 0. ``length`` is the doc's FULL
    weighted term mass (not truncated) — BM25's length normalization must
    see the real document size. Stored weights are RAW field-boosted tf
    (the scoring math is identical to the host scorer); only the CHOICE of
    surviving terms uses ``_selection_weight``."""
    tf = _doc_tf_uncached(_HitShim(text or "", symbol, path))
    items = sorted(
        tf.items(), key=lambda kv: -_selection_weight(kv[0], kv[1])
    )[:kterms]
    ids = np.full((kterms,), -1, dtype=np.int32)
    w = np.zeros((kterms,), dtype=np.float16)
    for i, (t, v) in enumerate(items):
        ids[i] = term_hash(t)
        w[i] = v
    return ids, w, np.float32(max(sum(tf.values()), 1.0))


def symbol_hash(symbol) -> int:
    """Whole-symbol term id for the symbol-bonus channel (-1 = none).

    Hashed in normalize_symbol space (lowercase, separators stripped) so a
    query can name the symbol literally OR as its word sequence — the query
    side (featurize_query_symbols) hashes both token and word-join
    candidates in the same space. Fingerprints are rebuilt from row_meta on
    snapshot load (store.load nulls the table), so no migration is needed."""
    if not symbol:
        return -1
    norm = normalize_symbol(symbol)
    if not norm:
        return -1
    return term_hash(norm)


def featurize_docs(
    metas: Sequence[dict], *, kterms: int = DEFAULT_KTERMS
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Batch ``featurize_doc`` over payload metadata dicts; the extra
    (n,) int32 channel is the whole-symbol hash for the exact-match bonus."""
    n = len(metas)
    ids = np.full((n, kterms), -1, dtype=np.int32)
    w = np.zeros((n, kterms), dtype=np.float16)
    ln = np.ones((n,), dtype=np.float32)
    sym = np.full((n,), -1, dtype=np.int32)
    for i, m in enumerate(metas):
        ids[i], w[i], ln[i] = featurize_doc(
            m.get("text"), m.get("symbol"), m.get("path"), kterms=kterms
        )
        sym[i] = symbol_hash(m.get("symbol"))
    return ids, w, ln, sym


def featurize_queries(
    texts: Sequence[Optional[str]], *, tmax: int = QUERY_TERMS
) -> np.ndarray:
    """-> (Q, tmax) int32 query term ids, -1-padded; textless rows all -1
    (their lexical score is 0 everywhere, so the blend preserves the dense
    order)."""
    out = np.full((len(texts), tmax), -1, dtype=np.int32)
    for i, t in enumerate(texts):
        if not t:
            continue
        toks = sorted(set(tokenize(t, limit=tmax)))[:tmax]
        for j, tok in enumerate(toks):
            out[i, j] = term_hash(tok)
    return out


def featurize_query_symbols(
    texts: Sequence[Optional[str]], *, smax: int = MAX_SYM_CANDIDATES
) -> np.ndarray:
    """-> (Q, smax) int32 symbol-candidate hashes, -1-padded.

    Hashes rerank.query_symbol_candidates (token + word-join candidates,
    normalize_symbol space) for the bm25_blend symbol-bonus channel; the
    host scorer compares the identical candidate list as strings, so the
    two impls agree on which candidates exist."""
    out = np.full((len(texts), smax), -1, dtype=np.int32)
    for i, t in enumerate(texts):
        if not t:
            continue
        for j, cand in enumerate(query_symbol_candidates(t)[:smax]):
            out[i, j] = term_hash(cand)
    return out


# queries per blend chunk: bounds the (q, W, K, T) match tensor
_BLEND_CHUNK = 8


def gather_fingerprints(mesh: Mesh, fp_ids, fp_w, fp_len, fp_sym, ids):
    """Gather candidate fingerprint rows by GLOBAL row id from row-sharded
    tables (``scan.rescore_global``'s ownership pattern,
    lexical.py:206-250): each shard gives the rows in its range and the
    empty fingerprint (ids -1, weights 0, length 0, symbol -1) for every
    other id, and the parts are summed, across processes too; the -1 that
    each of the shards but the owner adds to ids and symbols is then added
    back. -1 / unowned ids give the empty fingerprint. The tables are
    ``ShardedRows`` (a tensor in global row order is split first)."""
    n = n_shards(mesh)
    tables = [ShardedRows.of(mesh, t) for t in (fp_ids, fp_w, fp_len, fp_sym)]
    shard_rows = tables[0].shard_rows
    home = mesh.home
    ids = ids.to(torch.int64)
    total = None
    for rank, dev in local_shards(mesh):
        lo, hi = rank * shard_rows, (rank + 1) * shard_rows
        ids_d = ids.to(dev)
        mine = (ids_d >= lo) & (ids_d < hi)
        li = torch.clamp(ids_d - lo if lo else ids_d, 0, shard_rows - 1)
        g_ids, g_w, g_len, g_sym = (t.shard(rank)[li] for t in tables)
        parts = (
            torch.where(mine[..., None], g_ids, -1),
            torch.where(mine[..., None], g_w.to(torch.float32), 0.0),
            torch.where(mine, g_len, 0.0),
            torch.where(mine, g_sym, -1),
        )
        parts = tuple(p.to(home) for p in parts)
        total = parts if total is None else tuple(
            a + b for a, b in zip(total, parts))
    g_ids, g_w, g_len, g_sym = (all_reduce_sum(t, mesh) for t in total)
    if n > 1:
        g_ids, g_sym = g_ids + (n - 1), g_sym + (n - 1)
    return g_ids, g_w, g_len, g_sym


def _minmax(x, live):
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    hi = torch.where(live, x, -inf).amax(dim=-1, keepdim=True)
    lo = torch.where(live, x, inf).amin(dim=-1, keepdim=True)
    span = hi - lo
    ok = torch.isfinite(span) & (span > 1e-12)
    normed = torch.where(ok, (x - lo) / torch.where(ok, span, 1.0), 0.0)
    return torch.where(live, normed, 0.0)


def _blend_chunk(g_ids, g_w, g_len, g_sym, dense, q_ids, weight, sym_bonus,
                 q_sym, table, learned_weight):
    """bm25_blend for one chunk of queries -> (final (q, W), lex (q, W))."""
    live = dense > _NEG_INF / 2  # (Q, W)
    q_valid = q_ids >= 0  # (Q, T)
    match = (g_ids[:, :, :, None] == q_ids[:, None, None, :]) & q_valid[
        :, None, None, :
    ]
    tf = torch.sum(
        torch.where(match, g_w[:, :, :, None], 0.0), dim=2
    )  # (Q, W, T)
    n = torch.sum(live, dim=1, keepdim=True).to(torch.float32)  # (Q, 1)
    df = torch.sum((tf > 0) & live[:, :, None], dim=1).to(torch.float32)
    idf = torch.log1p((n - df + 0.5) / (df + 0.5))
    lens = torch.clamp(g_len, min=1.0)
    avg_len = torch.sum(torch.where(live, lens, 0.0), dim=1, keepdim=True) / (
        torch.clamp(n, min=1.0)
    )
    denom = tf + _K1 * (
        1.0 - _B + _B * lens[:, :, None]
        / torch.clamp(avg_len[:, :, None], min=1e-9)
    )
    lex = torch.sum(
        idf[:, None, :] * tf * (_K1 + 1.0) / torch.clamp(denom, min=1e-9),
        dim=2,
    )  # (Q, W)
    # symbol bonus: the query names this candidate's defining symbol ->
    # add sym_bonus * (the query's max idf)
    max_idf = torch.where(q_valid, idf, -float("inf")).amax(dim=1, keepdim=True)
    max_idf = torch.where(torch.isfinite(max_idf), max_idf, 0.0)
    sym_match = (
        (g_sym[:, :, None] == q_sym[:, None, :])
        & (q_sym >= 0)[:, None, :]
        & (g_sym >= 0)[:, :, None]
    ).any(dim=2)
    lex = lex + torch.where(sym_match, sym_bonus * max_idf, 0.0)
    lex = torch.where(live, lex, 0.0)
    final = (1.0 - weight) * _minmax(dense, live) + weight * _minmax(lex, live)
    if table is not None:
        n_buckets = table.shape[0]
        qe = table[torch.where(q_valid, q_ids % n_buckets, 0)]  # (Q, T, D)
        # the learned channel reads only the fingerprint head the table was
        # trained on (term_reranker.DOC_TERMS)
        g_ids_l = g_ids[:, :, :_LEARNED_DOC_TERMS]
        d_valid = g_ids_l >= 0  # (Q, W, K')
        de = table[torch.where(d_valid, g_ids_l % n_buckets, 0)]
        # (Q, W, K', D) x (Q, 1, D, T) -> (Q, W, K', T) -> (Q, W, T, K')
        sims = torch.matmul(de, qe.transpose(1, 2)[:, None]).transpose(2, 3)
        sims = torch.where(d_valid[:, :, None, :], sims, -1.0)
        best = sims.amax(dim=3)  # (Q, W, T)
        t_w = torch.where(q_valid, idf, 0.0)
        learned = torch.einsum("qwt,qt->qw", best, t_w) / torch.clamp(
            torch.sum(t_w, dim=1, keepdim=True), min=1e-9
        )
        # headroom- and coverage-gated boost (lexical.py:350-368)
        cover = torch.sum(
            torch.where(q_valid & (df > 0), idf, 0.0), dim=1, keepdim=True
        ) / torch.clamp(torch.sum(t_w, dim=1, keepdim=True), min=1e-9)
        lw_eff = learned_weight * (1.0 - cover)  # (Q, 1)
        base_n = _minmax(final, live)
        final = base_n + lw_eff * _minmax(
            torch.where(live, learned, 0.0), live
        ) * (1.0 - base_n)
    final = torch.where(live, final, -float("inf"))
    return final, lex


def bm25_blend(
    g_ids, g_w, g_len, g_sym, dense, q_ids, weight, sym_bonus, q_sym,
    table=None, learned_weight=None,
):
    """Window BM25 + dense blend (post-gather), as the reference's
    ``bm25_blend``: window df/idf, k1/b saturation, exact-symbol bonus,
    min-max blend, optional learned channel, then the final-then-lexical
    sort with a stable dense-order tie-break. Returns (final (Q, W),
    order (Q, W) int64)."""
    finals, lexes = [], []
    for lo in range(0, dense.shape[0], _BLEND_CHUNK):
        sl = slice(lo, lo + _BLEND_CHUNK)
        f, lx = _blend_chunk(
            g_ids[sl], g_w[sl], g_len[sl], g_sym[sl], dense[sl], q_ids[sl],
            weight, sym_bonus, q_sym[sl], table, learned_weight,
        )
        finals.append(f)
        lexes.append(lx)
    final = torch.cat(finals)
    lex = torch.cat(lexes)
    # stable two-key sort (final desc, lexical desc, dense order for full
    # ties): sort by the secondary key first, then stably by the primary
    sec = torch.argsort(-lex, dim=-1, stable=True)
    primary = torch.gather(final, 1, sec)
    prim = torch.argsort(-primary, dim=-1, stable=True)
    order = torch.gather(sec, 1, prim)
    return final, order


def rerank_device(
    fingerprints,  # (fp_ids (R,K), fp_w (R,K) f16, fp_len (R,), fp_sym (R,)):
                   # ShardedRows, or tensors in global row order
    scores,  # (Q, W) f32 device tensor or host array
    ids,  # (Q, W) int row ids, device tensor or host array
    q_ids,  # (Q, T) int32 host (featurize_queries)
    *,
    q_sym,  # (Q, S) int32 host (featurize_query_symbols)
    weight: float,
    sym_bonus: float = DEFAULT_SYM_BONUS,
    table=None,  # (B, D) unit-row f32 device tensor: learned MaxSim channel
    learned_weight: float = 0.0,
    mesh: Mesh,  # the fingerprints' mesh
):
    """Full device rerank step: sharded gather + BM25 + blend + reorder, on
    the mesh's first local device.

    Returns (scores, ids) reordered by the blended ranking, as device
    tensors. Scores returned are the ORIGINAL dense scores in the new order
    (the blend only decides order, as the host rerank_hits)."""
    fp_ids, fp_w, fp_len, fp_sym = fingerprints
    device = mesh.home
    ids_dev = torch.as_tensor(ids, device=device).to(torch.int64)
    scores_dev = torch.as_tensor(scores, device=device).to(torch.float32)
    g_ids, g_w, g_len, g_sym = gather_fingerprints(
        mesh, fp_ids, fp_w, fp_len, fp_sym, ids_dev
    )
    _, order = bm25_blend(
        g_ids, g_w, g_len, g_sym, scores_dev,
        torch.as_tensor(q_ids, device=device),
        float(np.float32(weight)), float(np.float32(sym_bonus)),
        torch.as_tensor(q_sym, device=device),
        table,
        float(np.float32(learned_weight)) if table is not None else None,
    )
    return (
        torch.gather(scores_dev, 1, order),
        torch.gather(ids_dev, 1, order),
    )


class LexicalFingerprints:
    """Host + device lifecycle for the per-row fingerprint arrays.

    Owned by the VectorStore (row ids are store-scoped: remapped by
    compaction, rebuilt on load). Mutations follow the store's writer lock;
    the device mirror is one tuple swapped as a whole and updated with
    out-of-place scatters, like the index's own device state. A lock-free
    reader may still have to build that mirror from the host arrays (after
    a growth or a remap dropped it), so the host arrays and the mirror
    change only under ``_mu``, which such a build takes too: it never mixes
    arrays of two generations, nor installs a mirror older than a write.
    The host arrays are whole in every process; the device mirror is
    ``ShardedRows``, each shard's rows on its own device."""

    def __init__(self, row_multiple: int, kterms: int = DEFAULT_KTERMS,
                 device: DeviceLike = None, mesh: Optional[Mesh] = None):
        # the table is row-sharded over ``mesh`` as the index is; its row
        # multiple (the store passes lcm(n_shards * 8, 128)) keeps the
        # shards equal
        self.mesh = resolve_mesh(mesh, device)
        self.device = self.mesh.home
        self.kterms = int(kterms)
        self._row_multiple = int(row_multiple)
        cap = self._row_multiple
        self._ids = np.full((cap, self.kterms), -1, dtype=np.int32)
        self._w = np.zeros((cap, self.kterms), dtype=np.float16)
        self._len = np.ones((cap,), dtype=np.float32)
        self._sym = np.full((cap,), -1, dtype=np.int32)
        self._dev: Optional[tuple] = None
        self._mu = threading.RLock()

    # -- host mutation (store writer lock held) ---------------------------

    def _grow(self, min_rows: int) -> None:
        cap = self._ids.shape[0]
        new_cap = cap
        while new_cap < min_rows:
            new_cap = max(new_cap * 2, self._row_multiple)
        new_cap = -(-new_cap // self._row_multiple) * self._row_multiple
        if new_cap == cap:
            return
        ids = np.full((new_cap, self.kterms), -1, dtype=np.int32)
        w = np.zeros((new_cap, self.kterms), dtype=np.float16)
        ln = np.ones((new_cap,), dtype=np.float32)
        sym = np.full((new_cap,), -1, dtype=np.int32)
        ids[:cap], w[:cap], ln[:cap] = self._ids, self._w, self._len
        sym[:cap] = self._sym
        self._ids, self._w, self._len, self._sym = ids, w, ln, sym
        self._dev = None

    def set_rows(self, rows: np.ndarray, metas: Sequence[dict]) -> None:
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return
        ids, w, ln, sym = featurize_docs(metas, kterms=self.kterms)
        with self._mu:
            self._grow(int(rows.max()) + 1)
            self._ids[rows] = ids
            self._w[rows] = w
            self._len[rows] = ln
            self._sym[rows] = sym
            dev = self._dev
            if dev is not None:
                at = dev[0].route(rows)
                vals = [torch.from_numpy(v).to(self.device) for v in (ids, w, ln, sym)]
                self._dev = tuple(arr.set_rows(at, v) for arr, v in zip(dev, vals))

    def remap(self, remap: np.ndarray) -> None:
        """Renumber rows after compaction (old row -> new row, -1 =
        dropped)."""
        remap = np.asarray(remap, dtype=np.int64)
        old_n = min(remap.shape[0], self._ids.shape[0])
        keep = np.flatnonzero(remap[:old_n] >= 0)
        new_rows = remap[keep]
        n_new = int(new_rows.max()) + 1 if new_rows.size else 0
        cap = max(
            -(-max(n_new, 1) // self._row_multiple) * self._row_multiple,
            self._row_multiple,
        )
        ids = np.full((cap, self.kterms), -1, dtype=np.int32)
        w = np.zeros((cap, self.kterms), dtype=np.float16)
        ln = np.ones((cap,), dtype=np.float32)
        sym = np.full((cap,), -1, dtype=np.int32)
        with self._mu:
            ids[new_rows] = self._ids[keep]
            w[new_rows] = self._w[keep]
            ln[new_rows] = self._len[keep]
            sym[new_rows] = self._sym[keep]
            self._ids, self._w, self._len, self._sym = ids, w, ln, sym
            self._dev = None

    def rebuild(self, row_meta: dict) -> None:
        """Re-featurize everything from the store's row metadata (load)."""
        if not row_meta:
            return
        rows = np.asarray(sorted(row_meta.keys()), dtype=np.int64)
        with self._mu:
            self._grow(int(rows.max()) + 1)
        self.set_rows(rows, [row_meta[int(r)] for r in rows])

    # -- device snapshot ----------------------------------------------------

    def device_arrays(self, min_rows: int) -> tuple:
        """Device mirror, one ``ShardedRows`` per array (each shard holds
        its own rows), padded to cover ``min_rows`` (the index's allocated
        rows) and the row multiple."""
        dev = self._dev
        if dev is not None and dev[0].shape[0] >= max(min_rows, 1):
            return dev  # the common case: no lock on the read path
        with self._mu:
            self._grow(max(min_rows, 1))
            dev = self._dev
            if dev is not None and dev[0].shape[0] >= self._ids.shape[0]:
                return dev
            dev = tuple(
                ShardedRows.from_host(self.mesh, a)
                for a in (self._ids, self._w, self._len, self._sym)
            )
            self._dev = dev
            return dev
