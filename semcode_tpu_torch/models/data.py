"""Training-pair construction for contrastive encoder training.

Counterpart of ``semcode_tpu/models/data.py``: the same seed, texts,
symbols, languages and paths give the same batches, bit for bit (numpy
only; the docstring and symbol helpers are the port's
``eval/quality.py``, the document prefix its
``embeddings/providers.embedding_text``).

Unsupervised pairs from the indexed corpus itself (no labels needed), mixing
three pair types that match the retrieval tasks the product actually serves
(the same distribution the quality harness measures, eval/quality.py):

- ``crop``: two random crops of the same chunk — layout/context invariance;
- ``doc``: the chunk's docstring/leading comment vs its code body —
  natural-language -> code retrieval (the RAG query path);
- ``symbol``: an identifier-lookup phrasing ("where is X defined", or the
  identifier split into words) vs the chunk — symbol/paraphrase lookup.

Batches are fixed-shape numpy arrays ready for
``ContrastiveTrainer.train_step``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class PairBatcher:
    def __init__(
        self,
        texts: Sequence[str],
        tokenizer,
        *,
        seq_len: int = 128,
        batch_size: int = 32,
        seed: int = 0,
        min_lines: int = 4,
        symbols: Optional[Sequence[Optional[str]]] = None,
        languages: Optional[Sequence[str]] = None,
        paths: Optional[Sequence[Optional[str]]] = None,
        mix: Tuple[float, float, float] = (0.5, 0.3, 0.2),  # crop, doc, symbol
        expand_docs: bool = True,  # positive side sees the same symbol+stem
        # prefix the indexer embeds (providers.embedding_text), so the
        # train-time document distribution matches serve-time window 0
        hard_frac: float = 0.25,  # fraction of the batch drawn as same-file
        # siblings of other batch members: natural hard negatives (similar
        # imports/style/vocabulary but different definitions), which in-batch
        # InfoNCE otherwise almost never samples from a large corpus
    ):
        keep = [i for i, t in enumerate(texts) if len(t.splitlines()) >= min_lines]
        self.texts = [texts[i] for i in keep]
        if not self.texts:
            raise ValueError("no texts long enough to build training pairs")
        self.tokenizer = tokenizer
        self.seq_len = int(seq_len)
        self.batch_size = int(batch_size)
        self.rng = np.random.default_rng(seed)
        self.hard_frac = float(hard_frac)
        self._by_path: dict = {}
        if paths is not None:
            paths = list(paths)
            for new_i, old_i in enumerate(keep):
                p = paths[old_i]
                if p:
                    self._by_path.setdefault(str(p), []).append(new_i)
            # only files with 2+ chunks can contribute sibling negatives
            self._by_path = {
                p: idxs for p, idxs in self._by_path.items() if len(idxs) > 1
            }
            self._path_of = {}
            for p, idxs in self._by_path.items():
                for i in idxs:
                    self._path_of[i] = p
        symbols = list(symbols) if symbols is not None else [None] * len(texts)
        languages = (
            list(languages) if languages is not None else ["text"] * len(texts)
        )
        self.symbols = [symbols[i] for i in keep]
        self.languages = [languages[i] for i in keep]
        # precompute task-pair anchors; fall back to crops when a chunk has
        # no docstring/symbol
        from ..eval.quality import _extract_docstring, _symbol_words

        self._docs: List[Optional[str]] = [
            _extract_docstring(t, lang)
            for t, lang in zip(self.texts, self.languages)
        ]
        self._sym_queries: List[Optional[str]] = []
        for sym in self.symbols:
            if not sym:
                self._sym_queries.append(None)
                continue
            words = _symbol_words(sym)
            self._sym_queries.append(
                f"where is {sym} defined"
                if not words or len(words) < 2
                else "code that implements " + " ".join(words)
            )
        self.mix = mix

        # PRE-TOKENIZE everything once (chunk bodies, docstrings, symbol-query
        # variants): per-batch text tokenization is host-CPU-bound; with id
        # arrays a batch is pure slicing.
        cap = 4 * self.seq_len
        if expand_docs:
            # the INDEXED text is embedding_text(body, symbol, path); training
            # positives must see the same prefix or the encoder treats it as
            # out-of-distribution noise at serve time
            from ..embeddings.providers import embedding_text

            if paths is not None:
                paths_list = list(paths)
                kept_paths = [paths_list[i] for i in keep]
            else:
                kept_paths = [None] * len(self.texts)
            body_texts = [
                embedding_text(t, symbol=s, path=p)
                for t, s, p in zip(self.texts, self.symbols, kept_paths)
            ]
        else:
            body_texts = self.texts
        self._body_ids: List[np.ndarray] = [
            self.tokenizer.encode_ids(t, cap=cap) for t in body_texts
        ]
        self._doc_ids: List[Optional[np.ndarray]] = [
            self.tokenizer.encode_ids(d, cap=self.seq_len) if d else None
            for d in self._docs
        ]
        self._sym_ids: List[Optional[List[np.ndarray]]] = []
        for i, sym in enumerate(self.symbols):
            if not sym or self._sym_queries[i] is None:
                self._sym_ids.append(None)
                continue
            variants = [
                self._sym_queries[i],
                f"where is {sym} defined",
                f"definition of {sym}",
            ]
            self._sym_ids.append(
                [self.tokenizer.encode_ids(v, cap=self.seq_len) for v in variants]
            )

    def _crop_ids(self, i: int) -> np.ndarray:
        ids = self._body_ids[i]
        n = len(ids)
        span = max(2, int(n * float(self.rng.uniform(0.5, 0.9))))
        start = int(self.rng.integers(0, max(n - span, 0) + 1))
        return ids[start : start + span]

    def _anchor_ids_for(self, i: int) -> np.ndarray:
        """Pick an anchor view of chunk i according to the task mix."""
        r = float(self.rng.uniform())
        crop_w, doc_w, _ = self.mix
        has_doc = self._doc_ids[i] is not None
        has_sym = self._sym_ids[i] is not None
        if r < crop_w or (not has_doc and not has_sym):
            return self._crop_ids(i)
        if r < crop_w + doc_w and has_doc:
            return self._doc_ids[i]
        if has_sym:
            # alternate phrasings so the encoder doesn't latch onto one template
            variants = self._sym_ids[i]
            return variants[int(self.rng.integers(0, len(variants)))]
        if has_doc:
            return self._doc_ids[i]
        return self._crop_ids(i)

    def _assemble(self, rows: List[np.ndarray]):
        from .tokenizer import CLS_ID, PAD_ID

        n = len(rows)
        ids = np.full((n, self.seq_len), PAD_ID, dtype=np.int32)
        mask = np.zeros((n, self.seq_len), dtype=np.int32)
        ids[:, 0] = CLS_ID
        mask[:, 0] = 1
        for r, row in enumerate(rows):
            row = row[: self.seq_len - 1]
            ids[r, 1 : 1 + len(row)] = row
            mask[r, 1 : 1 + len(row)] = 1
        return ids, mask

    def _pick_indices(self) -> List[int]:
        picks: List[int] = self.rng.choice(
            len(self.texts),
            size=self.batch_size,
            replace=len(self.texts) < self.batch_size,
        ).tolist()
        if not self._by_path or self.hard_frac <= 0:
            return picks
        # swap the tail of the batch for same-file siblings of the head:
        # each swap plants one hard negative pair inside the batch
        n_hard = min(int(self.batch_size * self.hard_frac), self.batch_size // 2)
        used = set(picks)
        for slot in range(n_hard):
            anchor = picks[slot]
            path = self._path_of.get(anchor)
            if path is None:
                continue
            sibs = [j for j in self._by_path[path] if j != anchor and j not in used]
            if not sibs:
                continue
            sib = sibs[int(self.rng.integers(0, len(sibs)))]
            victim = self.batch_size - 1 - slot
            used.discard(picks[victim])
            picks[victim] = sib
            used.add(sib)
        return picks

    def batches(self, n_batches: int) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(n_batches):
            picks = self._pick_indices()
            a_ids, a_mask = self._assemble([self._anchor_ids_for(i) for i in picks])
            p_ids, p_mask = self._assemble([self._crop_ids(i) for i in picks])
            yield {
                "anchor_ids": a_ids,
                "anchor_mask": a_mask,
                "pos_ids": p_ids,
                "pos_mask": p_mask,
            }
