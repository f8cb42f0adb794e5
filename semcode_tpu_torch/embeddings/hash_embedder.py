"""Deterministic hashed n-gram embedder with a device projection.

The default offline embedding provider: no trained weights, no network. Texts
are tokenized code-aware on the host (identifier splitting, camelCase /
snake_case decomposition), token uni+bigrams are feature-hashed into a large
bucket space, and the device turns the sparse bag into a dense unit vector by
gathering rows of a fixed pseudo-random projection matrix and weighted-summing
them — a random projection of a TF-weighted lexical vector, so cosine
similarity approximates lexical/structural overlap.

Counterpart of ``semcode_tpu/embeddings/hash_embedder.py``. The host
featurization below is a byte-for-byte copy of it. The projection matrix is
BIT-EQUAL to the JAX package's ``jax.random.normal(PRNGKey(seed), (buckets,
dim), bfloat16) * f32(1/sqrt(dim))``, so vectors from either package carry
the same signature and mix safely in one snapshot:

- bf16 has 7 mantissa bits, so JAX's uniform sampler keeps 8 random bits
  per element (the low byte of ``bits1 ^ bits2`` of threefry2x32 over the
  row-major flat counter) and uses their top 7: an element is one of 128
  bf16 normals;
- ``_threefry2x32`` reproduces those bits (on the target device, in
  wrapping int32 arithmetic) and ``_NORMAL_BF16`` holds the 128 values,
  generated once from JAX 0.9.0 (``jax_threefry_partitionable=True``) and
  checked against it by tests/test_torch_hash_embedder.py.
"""

from __future__ import annotations

import functools
import re
import zlib
from typing import List, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

_TOKEN_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*|\d+|[^\sA-Za-z0-9_]")
_CAMEL_RE = re.compile(
    r"[A-Z]+(?=[A-Z][a-z])|[A-Z]?[a-z]+|[A-Z]+|\d+"
)


def code_tokens(text: str) -> List[str]:
    """Code-aware tokenization: identifiers split on camelCase/snake_case."""
    out: List[str] = []
    for tok in _TOKEN_RE.findall(text):
        if "_" in tok:
            parts = [p for p in tok.split("_") if p]
        elif tok.isalnum() and not tok.isdigit():
            parts = _CAMEL_RE.findall(tok)
        else:
            parts = [tok]
        for p in parts:
            out.append(p.lower())
    return out


def _bucket(feature: str, n_buckets: int) -> int:
    return zlib.crc32(feature.encode("utf-8")) % n_buckets


def _sign(feature: str) -> float:
    return 1.0 if (zlib.crc32(feature.encode("utf-8")) >> 31) & 1 == 0 else -1.0


# Ubiquitous tokens carry no retrieval signal but dominate raw term
# frequency (a docstring query's "the/return/value" tokens would outweigh
# its one distinctive identifier). A corpus-level IDF is impossible in a
# stateless provider, so this fixed approximation downweights (a) english
# glue, (b) language keywords, (c) code nouns so generic they appear in
# most chunks. Held-out MRR motivated the factor (see docs/BENCHMARKS.md).
# The list is part of the embedding definition: changing it invalidates
# stored vectors, and the native featurizer (native/featurizer.cpp)
# mirrors it byte-for-byte — keep both in sync.
STOP_FACTOR = 0.3
# bump whenever the featurization changes meaning (tokens, weighting,
# stop list, projection): v2 = round-3 stop-token downweighting. Part of
# the provider signature, so stored vectors from another version are
# detected as stale on re-ingest instead of being silently mixed.
FEATURIZER_VERSION = 2
STOP_TOKENS = frozenset(
    """the a an of to and or in on for is are was be as at by with from
    this that it if else elif return def class import none true false
    self cls not no new del try except finally raise pass while do
    switch case break continue static void const let var function
    public private protected virtual override template typename using
    namespace struct enum union extern inline operator sizeof nullptr
    null undefined type types value values arg args kwargs param params
    parameter parameters obj object data result results name names key
    keys item items list dict str int float bool double long short
    unsigned char auto index val num count size len length get set add
    when then than must should which where there these those such other
    into over only also each all any some more most can cannot may
    might will would use used uses using given default optional
    returns true false same both two one first last next see note""".split()
)


def _stopped(feature: str) -> bool:
    """Is this feature a low-signal unigram? Bigrams keep full weight
    (two glue words in sequence are often a meaningful phrase), as do
    identifiers; single punctuation marks and bare digits are noise."""
    if "\x1f" in feature:
        return False
    if feature in STOP_TOKENS:
        return True
    return len(feature) == 1 and not feature.isalnum() or feature.isdigit()



# jax.random.normal(..., bfloat16) value for each 7-bit uniform index
_NORMAL_BF16 = (
    -2.890625, -2.328125, -2.109375, -1.953125, -1.8359375, -1.734375, -1.65625, -1.578125,
    -1.515625, -1.4609375, -1.40625, -1.3515625, -1.3046875, -1.2578125, -1.21875, -1.1796875,
    -1.140625, -1.1015625, -1.0625, -1.03125, -1.0, -0.97265625, -0.9375, -0.91015625,
    -0.87890625, -0.8515625, -0.82421875, -0.796875, -0.76953125, -0.74609375, -0.71875, -0.69140625,
    -0.66796875, -0.64453125, -0.62109375, -0.59765625, -0.57421875, -0.55078125, -0.52734375, -0.50390625,
    -0.482421875, -0.4609375, -0.439453125, -0.41796875, -0.3984375, -0.375, -0.353515625, -0.333984375,
    -0.3125, -0.29296875, -0.271484375, -0.251953125, -0.232421875, -0.212890625, -0.1923828125, -0.171875,
    -0.15234375, -0.1328125, -0.1123046875, -0.09326171875, -0.07373046875, -0.053955078125, -0.034423828125, -0.0146484375,
    0.0048828125, 0.0245361328125, 0.0439453125, 0.0634765625, 0.0830078125, 0.10302734375, 0.123046875, 0.142578125,
    0.162109375, 0.1826171875, 0.201171875, 0.22265625, 0.2412109375, 0.26171875, 0.283203125, 0.3046875,
    0.322265625, 0.34375, 0.365234375, 0.38671875, 0.408203125, 0.427734375, 0.44921875, 0.47265625,
    0.494140625, 0.515625, 0.5390625, 0.5625, 0.5859375, 0.609375, 0.6328125, 0.65625,
    0.6796875, 0.703125, 0.73046875, 0.7578125, 0.78515625, 0.8125, 0.83984375, 0.8671875,
    0.89453125, 0.921875, 0.95703125, 0.984375, 1.015625, 1.046875, 1.0859375, 1.125,
    1.15625, 1.1953125, 1.2421875, 1.28125, 1.328125, 1.3828125, 1.4375, 1.4921875,
    1.546875, 1.625, 1.703125, 1.7890625, 1.890625, 2.015625, 2.203125, 2.515625,
)

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _i32(v: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    v &= _MASK32
    return v - (1 << 32) if v >= 1 << 31 else v


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    # int32 shifts are arithmetic: mask the sign bits the right shift drags in
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _threefry2x32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds), the block cipher behind ``jax.random``
    (jax/_src/prng.py), on int32 tensors holding the uint32 bit patterns:
    int32 addition wraps like uint32 addition, and xor and shifts act on
    the same bits."""
    ks = (_i32(k1), _i32(k2), _i32(k1 ^ k2 ^ 0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl32(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + _i32(ks[(i + 2) % 3] + i + 1)
    return x0, x1


def jax_normal_bf16(
    seed: int, shape, device: torch.device, chunk: int = 1 << 22
) -> torch.Tensor:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, bfloat16)`` as an
    f32 tensor on ``device`` (values exact: every bf16 is an f32)."""
    n = int(np.prod(shape))
    if n >= 1 << 31:
        raise ValueError("projection too large for 32-bit counters")
    table = torch.tensor(_NORMAL_BF16, dtype=torch.float32, device=device)
    out = torch.empty(n, dtype=torch.float32, device=device)
    # PRNGKey(seed) without jax_enable_x64 (the reference's setting) keeps
    # the seed's low 32 bits: key = (0, seed mod 2^32); the counter is the
    # row-major flat index split in (high, low) words — high is 0 here
    k2 = int(seed) & _MASK32
    for lo in range(0, n, chunk):
        cnt = torch.arange(lo, min(lo + chunk, n), dtype=torch.int32, device=device)
        b1, b2 = _threefry2x32(0, k2, torch.zeros_like(cnt), cnt)
        out[lo : lo + cnt.numel()] = table[((b1 ^ b2) & 0xFF) >> 1]
    return out.reshape(tuple(shape))


def jax_normal_f32(
    seed: int, shape, device: torch.device, chunk: int = 1 << 22
) -> torch.Tensor:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)``:
    the same 32-bit draws (``b1 ^ b2`` of the counter's Threefry block),
    read as a uniform on ``[nextafter(-1, 0), 1)`` as jax does it, then
    ``sqrt(2) * erfinv(u)``. torch's erfinv is not XLA's polynomial, so a
    value may differ from jax's in its last bits (relative ~1e-6)."""
    n = int(np.prod(shape))
    if n >= 1 << 31:
        raise ValueError("draw too large for 32-bit counters")
    lo_val = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    span = np.float32(1.0) - lo_val  # rounds to 2.0 in float32, as in jax
    sqrt2 = np.float32(np.sqrt(2.0))
    out = torch.empty(n, dtype=torch.float32, device=device)
    k2 = int(seed) & _MASK32
    for lo in range(0, n, chunk):
        cnt = torch.arange(lo, min(lo + chunk, n), dtype=torch.int32, device=device)
        b1, b2 = _threefry2x32(0, k2, torch.zeros_like(cnt), cnt)
        # logical shift of the uint32 bits: mask what the arithmetic shift drags in
        mant = ((b1 ^ b2) >> 9) & 0x7FFFFF
        u = (mant | 0x3F800000).view(torch.float32) - 1.0
        u = torch.clamp_min(u * float(span) + float(lo_val), float(lo_val))
        out[lo : lo + cnt.numel()] = float(sqrt2) * torch.erfinv(u)
    return out.reshape(tuple(shape))


@functools.lru_cache(maxsize=4)
def _projection(seed: int, n_buckets: int, dim: int, device: str) -> torch.Tensor:
    """The fixed projection ``normal_bf16 * f32(1/sqrt(dim))``. Cached per
    (seed, shape, device): it is a constant (never written after creation)
    and costs seconds to generate on a CPU."""
    proj = jax_normal_bf16(seed, (n_buckets, dim), torch.device(device))
    return proj * np.float32(1.0 / np.sqrt(dim))


class HashEmbeddings:
    """embed_documents/embed_query via hashed n-grams + a device projection."""

    def __init__(
        self,
        dim: int = 384,
        *,
        n_buckets: int = 1 << 16,
        max_features: int = 256,
        seed: int = 7,
        batch_size: int = 256,
        use_native: bool = True,
        device: DeviceLike = None,
    ):
        self.dim = int(dim)
        self.n_buckets = int(n_buckets)
        self.max_features = int(max_features)
        self.batch_size = int(batch_size)
        self.use_native = use_native
        self.seed = int(seed)
        self.device = resolve_device(device)
        # fixed projection matrix, generated on device once (never trained)
        self._proj = _projection(
            self.seed, self.n_buckets, self.dim, str(self.device)
        )

    @classmethod
    def from_numpy_projection(
        cls, proj: np.ndarray, *, device: DeviceLike = None, **kwargs
    ) -> "HashEmbeddings":
        """An embedder over a given (n_buckets, dim) projection (tests feed
        the JAX package's matrix through here)."""
        proj = np.asarray(proj, dtype=np.float32)
        obj = cls.__new__(cls)
        obj.dim = int(proj.shape[1])
        obj.n_buckets = int(proj.shape[0])
        obj.max_features = int(kwargs.pop("max_features", 256))
        obj.batch_size = int(kwargs.pop("batch_size", 256))
        obj.use_native = bool(kwargs.pop("use_native", True))
        obj.seed = int(kwargs.pop("seed", 7))
        if kwargs:
            raise TypeError(f"unexpected arguments: {sorted(kwargs)}")
        obj.device = resolve_device(device)
        obj._proj = torch.from_numpy(proj).to(obj.device)
        return obj

    @property
    def signature(self) -> str:
        # the projection is bit-equal to the JAX package's, so the signature
        # is too: vectors from either package are interchangeable
        return (
            f"hash-v{FEATURIZER_VERSION}:d{self.dim}"
            f":b{self.n_buckets}:f{self.max_features}:s{self.seed}"
        )

    def projection(self) -> np.ndarray:
        return self._proj.cpu().numpy()

    # -- host featurization ----------------------------------------------------

    def _featurize(self, text: str):
        toks = code_tokens(text)[:2048]
        counts: dict = {}
        for t in toks:
            counts[t] = counts.get(t, 0) + 1
        for a, b in zip(toks, toks[1:]):
            bg = f"{a}\x1f{b}"
            counts[bg] = counts.get(bg, 0) + 1
        feats = sorted(counts.items(), key=lambda kv: -kv[1])[: self.max_features]
        ids = np.zeros(self.max_features, dtype=np.int32)
        wts = np.zeros(self.max_features, dtype=np.float32)
        for i, (f, c) in enumerate(feats):
            ids[i] = _bucket(f, self.n_buckets)
            w = (1.0 + np.log(c)) * _sign(f)
            if _stopped(f):
                w *= STOP_FACTOR
            wts[i] = w
        return ids, wts

    def _featurize_chunk(self, chunk: Sequence[str], pad: int):
        """Featurize a batch, using the native C++ path for ASCII texts
        (the native tokenizer is byte-level; unicode stays on the Python
        path so outputs are identical either way)."""
        ids = np.zeros((pad, self.max_features), dtype=np.int32)
        wts = np.zeros((pad, self.max_features), dtype=np.float32)
        native_idx = (
            [i for i, t in enumerate(chunk) if t.isascii()]
            if self.use_native
            else []
        )
        if native_idx:
            from .native import featurize_batch

            result = featurize_batch(
                [chunk[i] for i in native_idx], self.max_features, self.n_buckets
            )
            if result is None:
                native_idx = []
            else:
                ids[native_idx], wts[native_idx] = result
        native_set = set(native_idx)
        for i, t in enumerate(chunk):
            if i not in native_set:
                ids[i], wts[i] = self._featurize(t)
        return ids, wts

    # -- device projection -------------------------------------------------------

    def _project_device(self, ids: np.ndarray, wts: np.ndarray) -> torch.Tensor:
        return _project(
            self._proj,
            torch.from_numpy(ids).to(self.device, torch.int64),
            torch.from_numpy(wts).to(self.device),
        )

    def embed_documents(self, texts: Sequence[str]) -> List[List[float]]:
        if not texts:
            return []
        out: List[List[float]] = []
        for start in range(0, len(texts), self.batch_size):
            chunk = texts[start : start + self.batch_size]
            ids, wts = self._featurize_chunk(chunk, len(chunk))
            vecs = self._project_device(ids, wts).cpu().numpy()
            out.extend(v.tolist() for v in vecs)
        return out

    def embed_query(self, text: str) -> List[float]:
        return self.embed_documents([text])[0]

    def embed_queries(self, texts: Sequence[str]) -> List[List[float]]:
        # hashing featurizes queries and documents identically
        return self.embed_documents(texts)

    def embed_query_device(self, text: str) -> torch.Tensor:
        """Device-resident query embedding: a padded (8, dim) tensor, so the
        caller can chain straight into a device-side index search."""
        ids, wts = self._featurize_chunk([text], 8)
        return self._project_device(ids, wts)

    def embed_queries_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Device-resident BATCH query embedding, padded to a multiple of 8
        (padding rows are zero vectors). The serving path chains this into
        ``VectorStore.search_batch_device``."""
        n = len(texts)
        pad = max(8, -(-n // 8) * 8)
        ids, wts = self._featurize_chunk(list(texts), pad)
        return self._project_device(ids, wts)


def _project(proj: torch.Tensor, ids: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """(B, F) bucket ids + weights -> (B, d) unit rows (zero rows stay 0)."""
    rows = proj[ids]  # (B, F, d) gather
    emb = torch.sum(rows * wts[:, :, None], dim=1)
    norm = torch.linalg.vector_norm(emb, dim=1, keepdim=True)
    return emb / torch.clamp(norm, min=1e-9)
