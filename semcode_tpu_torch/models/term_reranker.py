"""Learned term-embedding table for the rerank's MaxSim channel.

Counterpart of ``semcode_tpu/models/term_reranker.py``: an embedding table
over HASHED term ids (the ``lexical.term_hash`` space the fingerprints
store), scored by late interaction: each of the query's hashed terms
takes its best cosine against the candidate's fingerprint terms (serving
weights the terms by idf in ``lexical.bm25_blend``; training averages
them). The table is trained by in-batch InfoNCE over (query, chunk) pairs that the eval
harness's generators make from external corpora (``build_pairs``,
``featurize_pairs``, ``train_term_table``). Training runs on one device
(CUDA unless asked for the CPU) under plain ``torch.optim.Adam``; the init
is the JAX package's ``0.02 * jax.random.normal(PRNGKey(seed))`` draw
(``hash_embedder.jax_normal_f32``) and the batches consume the numpy RNG in
its order, so the same features give the same steps.

Two of the reference's expressions are kept as they are: a pair's module
group is ``hash(dir)`` (Python salts a string's hash per process) and its
chunk key is ``id(meta)``, so ``featurize_pairs`` gives the same batches
only within one process. The shipped table is the JAX package's
(``default_asset_path``, read by path).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, f32_matmul, resolve_device
from ..embeddings.hash_embedder import jax_normal_f32

# table geometry: 2^17 hash buckets x 32 dims = 16 MB f32 (8 MB f16 on
# disk); collisions act like a fixed random tying of rare terms, which
# InfoNCE tolerates (both colliding terms pull toward their shared contexts)
DEFAULT_BUCKETS = 131072
DEFAULT_DIM = 32
DOC_TERMS = 96  # training-side fingerprint truncation (top by selection weight)


def bucketize(ids: np.ndarray, n_buckets: int = DEFAULT_BUCKETS) -> np.ndarray:
    """term_hash (31-bit) -> table bucket; -1 padding stays -1."""
    ids = np.asarray(ids)
    return np.where(ids >= 0, ids % n_buckets, -1)


# -- training ----------------------------------------------------------------


def build_pairs(
    metas: Sequence[Tuple[str, dict]],
    *,
    max_per_kind: int = 4000,
    seed: int = 0,
) -> List[Tuple[str, dict]]:
    """(query_text, chunk_meta) training pairs via the eval generators.

    ``metas``: (chunk_id, meta) with text/symbol/path/language. The
    positive is the chunk each query was generated from, so the pair
    distribution matches the query kinds the product serves."""
    from ..eval.quality import generate_queries

    by_id = {pid: m for pid, m in metas}
    pairs: List[Tuple[str, dict]] = []
    for q in generate_queries(metas, max_per_kind=max_per_kind, seed=seed):
        # any relevant chunk is a true positive
        pid = next(iter(q.relevant), None)
        meta = by_id.get(pid)
        if meta is not None:
            pairs.append((q.text, meta))
    return pairs


def featurize_pairs(
    pairs: Sequence[Tuple[str, dict]],
    *,
    n_buckets: int = DEFAULT_BUCKETS,
    doc_terms: int = DOC_TERMS,
) -> Dict[str, np.ndarray]:
    """Hash both sides of every pair into fixed-width id arrays.

    Returns q_ids (N, T) and d_ids (N, doc_terms), both bucketized with -1
    padding, and each pair's module group and chunk key. Doc terms come
    from the SERVING fingerprint recipe (lexical.featurize_doc) truncated to
    its top ``doc_terms`` slots."""
    from ..index.lexical import featurize_doc, featurize_queries

    q_ids = bucketize(
        featurize_queries([q for q, _ in pairs]), n_buckets
    ).astype(np.int32)
    d_ids = np.full((len(pairs), doc_terms), -1, dtype=np.int32)
    groups = np.zeros((len(pairs),), dtype=np.int64)
    chunks = np.zeros((len(pairs),), dtype=np.int64)
    fp_cache: Dict[Tuple, int] = {}
    for i, (_, m) in enumerate(pairs):
        key = (m.get("path"), m.get("symbol"), id(m))
        row = fp_cache.get(key)
        if row is None:
            ids, _, _ = featurize_doc(
                m.get("text"), m.get("symbol"), m.get("path"),
                kterms=doc_terms,
            )
            d_ids[i] = bucketize(ids, n_buckets)
            fp_cache[key] = i
        else:
            d_ids[i] = d_ids[row]
        # hard-negative group: the positive's module directory (serving
        # discriminates among topically-close candidates)
        path = str(m.get("path") or "")
        groups[i] = hash(path.rsplit("/", 1)[0])
        chunks[i] = id(m)  # distinct positives per batch (label validity)
    return {"q_ids": q_ids, "d_ids": d_ids, "group": groups, "chunk": chunks}


def init_table(n_buckets: int, dim: int, seed: int, device: torch.device) -> torch.Tensor:
    """``0.02 * jax.random.normal(PRNGKey(seed), (n_buckets, dim), float32)``."""
    return 0.02 * jax_normal_f32(seed, (n_buckets, dim), device)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-9)


def score_all(table: torch.Tensor, q_ids: torch.Tensor, d_ids: torch.Tensor) -> torch.Tensor:
    """(B, T) query terms x (B, K) doc terms -> (B, B) MaxSim scores: for
    each query and doc, the mean over the query's terms of the best cosine
    against the doc's terms (padding: -1 on either side)."""
    qe = _unit_rows(table[q_ids.clamp_min(0)])  # (B, T, D)
    de = _unit_rows(table[d_ids.clamp_min(0)])  # (B, K, D)
    b, t, dim = qe.shape
    k = de.shape[1]
    qv = (q_ids >= 0).float()
    dv = d_ids >= 0
    sims = f32_matmul(qe.reshape(b * t, dim), de.reshape(-1, dim).t())
    sims = sims.view(b, t, b, k).permute(0, 2, 1, 3)  # (B, B, T, K)
    sims = torch.where(dv[None, :, None, :], sims, -1.0)
    # amax: a tie shares the gradient evenly, as jnp.max's does
    best = torch.amax(sims, dim=3)  # (B, B, T)
    num = torch.einsum("qpt,qt->qp", best, qv)
    return num / qv.sum(dim=1, keepdim=True).clamp_min(1.0)


def term_loss(table: torch.Tensor, logit_scale: torch.Tensor, q_ids: torch.Tensor,
              d_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch's InfoNCE loss on the diagonal of the scaled MaxSim scores,
    and its argmax accuracy."""
    logits = score_all(table, q_ids, d_ids) * torch.exp(logit_scale)
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = F.cross_entropy(logits, labels)
    acc = (logits.detach().argmax(dim=1) == labels).float().mean()
    return loss, acc


def train_term_table(
    feats: Dict[str, np.ndarray],
    *,
    n_buckets: int = DEFAULT_BUCKETS,
    dim: int = DEFAULT_DIM,
    steps: int = 2000,
    batch_size: int = 256,
    lr: float = 3e-3,
    seed: int = 0,
    log_every: int = 100,
    q_dropout: float = 0.2,  # per-batch query-term masking (robustness:
    # real queries carry glue words and partial term sets)
    exact_dropout: float = 0.5,  # drop query terms that literally appear
    # in the positive's fingerprint: exact matches let InfoNCE score high
    # accuracy without learning any synonymy (BM25 already owns exact
    # matches); masking them forces the table to rank the positive through
    # RELATED terms
    log=print,
    device: DeviceLike = None,
) -> np.ndarray:
    """In-batch InfoNCE over MaxSim scores; returns the (B, D) f32 table.

    Each step embeds both sides, scores every query against every doc in
    the batch (B x B) and takes the cross entropy on the diagonal; a
    learnable logit scale (CLIP-style) sets the temperature."""
    dev = resolve_device(device)
    q_all, d_all = feats["q_ids"], feats["d_ids"]
    n = q_all.shape[0]
    if n < batch_size:
        raise ValueError(f"need >= {batch_size} pairs, got {n}")
    rng = np.random.default_rng(seed)

    group = feats.get("group")
    chunk = feats.get("chunk")
    by_group: Dict[int, np.ndarray] = {}
    if group is not None:
        for g in np.unique(group):
            idxs = np.flatnonzero(group == g)
            if idxs.size >= 8:  # too-small groups fold into random fill
                by_group[int(g)] = idxs
    group_keys = list(by_group)

    def sample_batch() -> np.ndarray:
        """Half the batch from ONE module group (hard negatives: shared
        vocabulary), half random; positives deduped so InfoNCE labels stay
        valid (two queries of one chunk in a batch would mark a true
        positive as negative)."""
        picked: List[int] = []
        seen_chunks = set()

        def add_from(idxs):
            for i in idxs:
                if len(picked) >= batch_size:
                    return
                c = int(chunk[i]) if chunk is not None else i
                if c in seen_chunks:
                    continue
                seen_chunks.add(c)
                picked.append(int(i))

        if group_keys:
            g = group_keys[rng.integers(len(group_keys))]
            idxs = by_group[g]
            add_from(rng.permutation(idxs)[: batch_size // 2])
        add_from(rng.permutation(n))
        return np.asarray(picked[:batch_size])

    table = init_table(n_buckets, dim, seed, dev).requires_grad_(True)
    logit_scale = torch.tensor(np.log(10.0), dtype=torch.float32, device=dev,
                               requires_grad=True)
    opt = torch.optim.Adam([table, logit_scale], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    for step in range(1, steps + 1):
        idx = sample_batch()
        qb = q_all[idx]
        if exact_dropout > 0:
            matched = np.stack(
                [np.isin(qb[i], d_all[idx[i]]) for i in range(len(idx))]
            ) & (qb >= 0)
            drop_m = matched & (rng.random(qb.shape) < exact_dropout)
            kills_all = ((qb >= 0) & ~drop_m).sum(axis=1) == 0
            drop_m[kills_all] = False
            qb = np.where(drop_m, -1, qb)
        if q_dropout > 0:
            drop = (rng.random(qb.shape) < q_dropout) & (qb >= 0)
            # never drop a query's LAST term (an all-pad query has score 0
            # against everything and poisons the batch loss)
            kills_all = ((qb >= 0) & ~drop).sum(axis=1) == 0
            drop[kills_all] = False
            qb = np.where(drop, -1, qb)
        q_ids = torch.from_numpy(np.ascontiguousarray(qb, dtype=np.int64)).to(dev)
        d_ids = torch.from_numpy(np.ascontiguousarray(d_all[idx], dtype=np.int64)).to(dev)
        opt.zero_grad(set_to_none=True)
        loss, acc = term_loss(table, logit_scale, q_ids, d_ids)
        loss.backward()
        opt.step()
        if log_every and (step % log_every == 0 or step == steps):
            log(
                f"term-reranker step {step}/{steps} "
                f"loss={loss.item():.4f} acc={acc.item():.3f}"
            )
    return table.detach().cpu().numpy().astype(np.float32)


# -- persistence --------------------------------------------------------------


def save_table(table: np.ndarray, path) -> None:
    """Rows are L2-normalized BEFORE saving (serving treats dot as cosine)
    and stored f16 — 8 MB at the default geometry."""
    table = np.asarray(table, dtype=np.float32)
    norm = np.linalg.norm(table, axis=1, keepdims=True)
    table = table / np.maximum(norm, 1e-9)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, table=table.astype(np.float16))


def load_table(path) -> Optional[np.ndarray]:
    """-> (B, D) f32 unit-row table, or None when the file is absent."""
    path = Path(path)
    if not path.exists():
        return None
    with np.load(path) as z:
        table = np.asarray(z["table"], dtype=np.float32)
    norm = np.linalg.norm(table, axis=1, keepdims=True)
    return table / np.maximum(norm, 1e-9)


def default_asset_path() -> Path:
    """The table shipped with the JAX package (a data file, read by path)."""
    root = Path(__file__).resolve().parents[2]
    return root / "semcode_tpu" / "assets" / "term-reranker.npz"
