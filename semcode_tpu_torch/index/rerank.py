"""Second-stage lexical rerank of dense retrieval candidates.

The reference's retrieval is single-stage: Milvus ANN scores only
(reference src/semcode/storage/milvus_store.py:135-148) with whatever
semantic quality the hosted embedding provides. Production code search
works markedly better as retrieve-then-rerank: the dense index nominates a
candidate window (top_k*depth instead of top_k: a wider selection from
the same scan), then an EXACT lexical scorer re-orders the window on the
host using the query text and each candidate's real
text/symbol/path. Identifier-shaped queries ("where is ClientSession
defined") and docstring queries (whose words literally appear in the
target chunk) gain the most — exactly the query kinds the quality harness
(eval/quality.py) measures.

Scorer: BM25 computed within the candidate window (df/idf over the window,
standard k1/b saturation) over identifier-aware tokens (camelCase and
snake_case subwords + the whole identifier), with field boosts: tokens
from the chunk's defining symbol count 3x, from the file stem 2x, body 1x.
The final order blends min-max-normalized dense and lexical scores;
`weight` (settings search_rerank_weight) is the lexical share. Host cost
is O(window * tokens) pure python/numpy on <= a few dozen candidates per
query.
"""

from __future__ import annotations

import math
import re
import threading
from collections import Counter, OrderedDict
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import numpy as np

# deliberately independent of embeddings/hash_embedder.py's tokenizer: that
# one must stay bit-identical to native/featurizer.cpp and to every indexed
# corpus; this one only needs to agree with ITSELF between query and doc.
# (The STOP list is a frozen word set, not tokenizer behavior — sharing it
# is safe and keeps "what counts as glue" consistent across scorers.)
from ..embeddings.hash_embedder import STOP_TOKENS as _STOP_WORDS  # noqa: E402

_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_CAMEL = re.compile(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])")
_K1 = 1.2
_B = 0.75
# symbol bonus (shared with the device scorer, index/lexical.py): when the
# query names a candidate's defining symbol — literally or as a joined word
# sequence (query_symbol_candidates) — add bonus * (the query's max idf) to
# its lexical score. Held-out lab (tools/rerank_lab.py) at the join-aware
# channel: aiohttp MRR@10 0.909 (0.75) -> 0.930 (1.0) with docstring-kind
# MRR unchanged; 1.25+ starts overriding genuine content matches (docstring
# 0.924 -> 0.917). Reference corpus ties at 0.9945 for 0.75-1.0.
DEFAULT_SYM_BONUS = 1.0
_BODY_CHAR_CAP = 6000  # chunker caps chunks at 6000 chars already
# bound host tokenization cost per candidate (~worst-case 6000-char chunks
# are ~700 identifiers; the rerank signal is front-loaded: docstrings and
# definition headers live at the chunk head, and symbol/path fields are
# boosted separately)
_BODY_TOKEN_CAP = 800


_NON_ALNUM = re.compile(r"[^a-z0-9]+")
# candidate-list cap shared with the device scorer: featurize_query_symbols
# hashes this exact list into a fixed-width (Q, S) channel, so the host and
# device scorers must agree on which candidates survive the cut
MAX_SYM_CANDIDATES = 128
_JOIN_MAX = 6  # longest run of query words joined into one candidate


def normalize_symbol(sym) -> str:
    """Join-normalized identifier: lowercase with every separator stripped,
    so ``parse_config_file``, ``ParseConfigFile`` and the word sequence
    "parse config file" all normalize to ``parseconfigfile``. Both the
    symbol-bonus channels (host rerank_hits and device bm25_blend) compare
    in this space."""
    return _NON_ALNUM.sub("", str(sym).lower())


def query_symbol_candidates(query_text: str) -> List[str]:
    """Normalized forms under which a query might NAME a defining symbol.

    Two sources, in priority order under the shared cap:

    - every query token (whole identifiers and their subwords), normalized —
      the literal-lookup channel ("where is parse_config_file defined");
    - JOINS of 2..6 consecutive query words — the paraphrase channel: a
      user asking for "parse config file" or "parse the config" names
      ``parse_config_file`` / ``parse_config`` without typing the
      identifier. For each word n-gram both the full join and the join of
      its non-stop members are candidates (the latter lets glue words
      inside the phrase — "parse THE config" — still hit the symbol).

    Grams made entirely of stop words are skipped. The list is deduped,
    order-stable, and capped at MAX_SYM_CANDIDATES (singles and joins each
    get half the budget) so the device scorer's fixed-width hash channel
    (index/lexical.featurize_query_symbols) sees the identical set."""
    half = MAX_SYM_CANDIDATES // 2
    singles: List[str] = []
    seen: set = set()
    for t in tokenize(query_text, limit=64):
        nt = _NON_ALNUM.sub("", t)
        if len(nt) > 1 and nt not in seen:
            seen.add(nt)
            singles.append(nt)
    words = [w.lower() for w in _IDENT.findall(query_text)[:48]]
    stop = [w in _STOP_WORDS for w in words]
    joins: List[str] = []
    jseen: set = set()

    def _add_join(j: str) -> None:
        if len(j) > 3 and j not in seen and j not in jseen:
            jseen.add(j)
            joins.append(j)

    # content-only grams first: when the cap bites, "config file" beats
    # "that implements"
    for content_only in (True, False):
        for n in range(2, _JOIN_MAX + 1):
            for i in range(len(words) - n + 1):
                gram = words[i : i + n]
                gstop = stop[i : i + n]
                if all(gstop):
                    continue
                if content_only != (not any(gstop)):
                    continue
                _add_join(_NON_ALNUM.sub("", "".join(gram)))
                if any(gstop):
                    content = [w for w, s in zip(gram, gstop) if not s]
                    if len(content) >= 2:
                        _add_join(_NON_ALNUM.sub("", "".join(content)))
            if len(joins) >= half:
                break
        if len(joins) >= half:
            break
    return singles[:half] + joins[:half]


@lru_cache(maxsize=65536)
def _subtokens(tok: str) -> tuple:
    """Lowercased identifier plus its snake_case/camelCase subwords when it
    splits (so "ClientSession" matches both "clientsession" and
    "client session" queries). Cached: candidate windows re-use the same
    identifiers heavily, and the split is the hot regex."""
    parts = tuple(
        p.lower()
        for piece in tok.split("_")
        for p in _CAMEL.split(piece)
        if len(p) > 1
    )
    low = tok.lower()
    if len(parts) > 1:
        return (low,) + parts
    return (low,)


def tokenize(text: str, *, limit: Optional[int] = None) -> List[str]:
    """Identifier-aware tokens (see _subtokens)."""
    raw = _IDENT.findall(text)
    if limit is not None:
        raw = raw[:limit]
    out: List[str] = []
    for tok in raw:
        out.extend(_subtokens(tok))
    return out


def _weighted_tf(
    text: str, weight: float, tf: Dict[str, float],
    limit: Optional[int] = None,
) -> None:
    """Accumulate field-boosted tf. findall + Counter run at C speed; the
    python loop is over UNIQUE identifiers only (~200 per 6000-char chunk),
    which is what makes 50-candidate windows a ~1 ms host stage."""
    raw = _IDENT.findall(text)
    if limit is not None:
        raw = raw[:limit]
    for tok, cnt in Counter(raw).items():
        for s in _subtokens(tok):
            tf[s] = tf.get(s, 0.0) + weight * cnt


def _doc_tf_uncached(hit) -> Dict[str, float]:
    """Field-boosted term frequencies for one candidate hit."""
    tf: Dict[str, float] = {}
    _weighted_tf((hit.text or "")[:_BODY_CHAR_CAP], 1.0, tf,
                 limit=_BODY_TOKEN_CAP)
    symbol = (hit.metadata or {}).get("symbol")
    if symbol:
        _weighted_tf(str(symbol), 3.0, tf)
    if hit.path:
        stem = str(hit.path).rsplit("/", 1)[-1].rsplit(".", 1)[0]
        _weighted_tf(stem, 2.0, tf)
    return tf


# Hot candidates repeat across queries (a static corpus between mutations),
# so tf maps are cached content-keyed: id + text length + a 128-char prefix
# hash. Content-derived keys stay correct across store snapshots without
# any coordination; a same-id re-ingest with different text misses the key.
_TF_CACHE: "OrderedDict[tuple, Dict[str, float]]" = OrderedDict()
_TF_CACHE_MAX = 4096
_TF_LOCK = threading.Lock()


def _doc_tf(hit) -> Dict[str, float]:
    # full-text hash: chunk ids are SPAN-based (md5 of repo:path:lines,
    # services/indexer.py), so a re-ingested chunk keeps its id with new
    # content — only the content itself can key the cache. python caches
    # str.__hash__ per string object, so this is amortized-free for hits
    # served repeatedly from the same row_meta snapshot. symbol/path feed
    # the boosted fields, so they key too.
    text = hit.text or ""
    key = (
        hit.id, len(text), hash(text),
        (hit.metadata or {}).get("symbol"), hit.path,
    )
    with _TF_LOCK:
        tf = _TF_CACHE.get(key)
        if tf is not None:
            _TF_CACHE.move_to_end(key)
            return tf
    tf = _doc_tf_uncached(hit)
    with _TF_LOCK:
        _TF_CACHE[key] = tf
        while len(_TF_CACHE) > _TF_CACHE_MAX:
            _TF_CACHE.popitem(last=False)
    return tf


def rerank_hits(
    query_text: str,
    hits: Sequence,
    top_k: int,
    *,
    weight: float,
    sym_bonus: float = DEFAULT_SYM_BONUS,
) -> List:
    """Blend window-BM25 lexical scores into the dense order; return the
    top_k hits re-sorted. `hits` must be in dense-score order (desc)."""
    if weight <= 0.0 or len(hits) <= 1 or not query_text:
        return list(hits[:top_k])
    q_tokens = set(tokenize(query_text, limit=64))
    if not q_tokens:
        return list(hits[:top_k])

    docs = [_doc_tf(h) for h in hits]
    n = len(docs)
    lengths = np.asarray(
        [max(sum(d.values()), 1.0) for d in docs], dtype=np.float64
    )
    avg_len = float(lengths.mean())
    df = {
        t: sum(1 for d in docs if t in d)
        for t in q_tokens
    }
    lex = np.zeros(n, dtype=np.float64)
    max_idf = 0.0
    for t in q_tokens:
        dft = df[t]
        idf = math.log(1.0 + (n - dft + 0.5) / (dft + 0.5))
        max_idf = max(max_idf, idf)
        if dft == 0:
            continue
        for i, d in enumerate(docs):
            tf = d.get(t)
            if tf:
                lex[i] += idf * (
                    tf * (_K1 + 1.0)
                    / (tf + _K1 * (1.0 - _B + _B * lengths[i] / avg_len))
                )
    if sym_bonus > 0.0:
        # symbol bonus, identical to the device scorer's channel: the query
        # names a candidate's defining symbol either literally (token match)
        # or as a word sequence that joins into it ("parse config file" ->
        # parse_config_file) — comparison happens in normalize_symbol space
        cands = set(query_symbol_candidates(query_text))
        if cands:
            for i, h in enumerate(hits):
                sym = (getattr(h, "metadata", None) or {}).get("symbol")
                if sym and normalize_symbol(sym) in cands:
                    lex[i] += sym_bonus * max_idf

    dense = np.asarray([h.score for h in hits], dtype=np.float64)
    # belt-and-braces: a sentinel/non-finite dense score would make the
    # min-max span meaningless (store paths scrub these before hits exist)
    finite = np.isfinite(dense)
    if not finite.all():
        fill = float(dense[finite].min()) if finite.any() else 0.0
        dense = np.where(finite, dense, fill)

    def _minmax(x: np.ndarray) -> np.ndarray:
        span = float(x.max() - x.min())
        if span <= 1e-12:
            return np.zeros_like(x)
        return (x - x.min()) / span

    final = (1.0 - weight) * _minmax(dense) + weight * _minmax(lex)
    # blend ties happen at the window extremes (dense-best vs lexical-best
    # at weight 0.5); break them toward the EXACT evidence. lexsort is
    # stable, so full ties keep the dense order.
    order = np.lexsort((-lex, -final))
    return [hits[i] for i in order[:top_k]]
