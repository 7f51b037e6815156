"""Bag-of-words vocabulary + place recognition scoring.

Replaces the DBoW2 stack (FeatureVocabulary wrappers src/features/
FeatureVocabulary.h + PlaceRecognizer src/core/PlaceRecognizer.{h,cc}):

- a hierarchical k-medians tree over binary descriptors stored as flat
  arrays (centers [n_nodes, 8]u32, children [n_nodes, k]), trained with
  batched Hamming k-means;
- BoW transform = batched tree descent (one Hamming-matmul + argmin per
  level for ALL descriptors of a frame at once);
- scoring = dense L1 BoW similarity (DBoW2 L1 score
  s = 1 - 0.5*|a - b|_1 on L1-normalized tf-idf vectors) against the
  keyframe BoW matrix — one matmul-class op instead of an inverted file
  (the inverted index is a CPU pruning structure; the dense form keeps
  the arena's fixed shapes, SURVEY.md §7.1).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from hyslam_tpu.ops.hamming import hamming_matrix, pack_bits, unpack_bits


class Vocabulary(NamedTuple):
    centers: jnp.ndarray    # [n_nodes, 8] uint32 node centers
    children: jnp.ndarray   # [n_nodes, k] int32 child node ids (-1 leaf)
    word_id: jnp.ndarray    # [n_nodes] int32 leaf -> word index (-1 internal)
    idf: jnp.ndarray        # [n_words] f32 inverse document frequency
    k: int
    depth: int

    @property
    def n_words(self) -> int:
        return self.idf.shape[0]


def train_vocabulary(descs: np.ndarray, k: int = 10, depth: int = 3,
                     seed: int = 0, iters: int = 8) -> Vocabulary:
    """Hierarchical k-medians over binary descriptors [N, 8]u32.

    Each node clusters its descriptors into k children by Hamming k-means
    (mean-then-threshold medians). Depth d gives up to k^d words."""
    rng = np.random.default_rng(seed)
    bits_all = np.asarray(unpack_bits(jnp.asarray(descs), jnp.float32))

    centers = [np.zeros(8, np.uint32)]     # node 0 = root (center unused)
    children: list[list[int]] = [[]]
    word_id = [-1]

    def kmeans(bits):
        n = len(bits)
        kk = min(k, n)
        if kk == 0:
            return None, None
        idx = rng.choice(n, kk, replace=False)
        C = bits[idx].copy()
        for _ in range(iters):
            d = (bits[:, None, :] != C[None, :, :]).sum(-1)
            a = d.argmin(1)
            for j in range(kk):
                m = a == j
                if m.any():
                    C[j] = (bits[m].mean(0) > 0.5).astype(bits.dtype)
        d = (bits[:, None, :] != C[None, :, :]).sum(-1)
        return C, d.argmin(1)

    # BFS expansion
    frontier = [(0, bits_all, 0)]  # (node, member bits, level)
    words = 0
    while frontier:
        node, bits, level = frontier.pop()
        if level >= depth or len(bits) <= k:
            word_id[node] = words
            words += 1
            continue
        C, assign = kmeans(bits)
        ch = []
        for j in range(len(C)):
            cid = len(centers)
            centers.append(
                np.asarray(pack_bits(jnp.asarray(C[j][None])), np.uint32)[0]
            )
            children.append([])
            word_id.append(-1)
            ch.append(cid)
            frontier.append((cid, bits[assign == j], level + 1))
        children[node] = ch

    n_nodes = len(centers)
    ch_arr = np.full((n_nodes, k), -1, np.int32)
    for i, ch in enumerate(children):
        ch_arr[i, : len(ch)] = ch
    return Vocabulary(
        centers=jnp.asarray(np.stack(centers)),
        children=jnp.asarray(ch_arr),
        word_id=jnp.asarray(np.asarray(word_id, np.int32)),
        idf=jnp.ones((words,), jnp.float32),
        k=k,
        depth=depth,
    )


def train_vocabulary_batched(descs: np.ndarray, k: int = 10, depth: int = 4,
                             doc_id: np.ndarray | None = None,
                             seed: int = 0, iters: int = 6) -> Vocabulary:
    """Level-parallel hierarchical k-medians for LARGE corpora (hundreds of
    thousands of descriptors, k^depth up to ~100k words) — the scale of the
    reference's shipped DBoW2 ORB vocabulary (System.cc:86).

    Unlike train_vocabulary (per-node Python recursion, fine for tiny
    self-trained fallbacks), every level clusters ALL nodes at once: one
    [N,k] packed-Hamming argmin per iteration (device op) + 256 bincounts
    for the bit-median update (C loops). doc_id [N] (e.g. source image
    index) enables idf weighting: idf = ln(n_docs / df_word)."""
    rng = np.random.default_rng(seed)
    descs = np.ascontiguousarray(np.asarray(descs, np.uint32))
    N = len(descs)
    bits = np.asarray(unpack_bits(jnp.asarray(descs), jnp.uint8))  # [N,256]
    descs_j = jnp.asarray(descs)

    centers_out = [np.zeros((1, 8), np.uint32)]     # node 0 = root
    children_out = [np.full((1, k), -1, np.int32)]
    node_base = 1                                    # next node id
    slot = np.zeros(N, np.int64)                     # dense node slot / desc
    level_node_ids = np.asarray([0], np.int64)       # node id per slot

    @partial(jax.jit, static_argnames=("kk",))
    def assign_step(C, sl, kk):
        cen = C[sl]                                          # [N,k,8]
        d = jnp.sum(jax.lax.population_count(
            jnp.bitwise_xor(cen, descs_j[:, None, :])), axis=-1)
        return jnp.argmin(d, axis=-1).astype(jnp.int32)

    for level in range(depth):
        M = len(level_node_ids)
        # seed k centers per slot from its own members
        order = np.lexsort((rng.random(N), slot))
        sl_sorted = slot[order]
        starts = np.searchsorted(sl_sorted, np.arange(M))
        pos = np.arange(N) - starts[sl_sorted]
        sm = pos < k
        C = np.zeros((M, k, 8), np.uint32)
        C[sl_sorted[sm], pos[sm]] = descs[order[sm]]
        child_seen = np.zeros((M, k), bool)
        child_seen[sl_sorted[sm], pos[sm]] = True
        # nodes with < k members: duplicate the first member into unused
        # seed rows so all-zero centers never attract assignments
        first = descs[order[starts]]                  # [M,8] first member
        C[~child_seen] = np.repeat(first, k, axis=0).reshape(
            M, k, 8)[~child_seen]

        slj = jnp.asarray(slot)
        a = None
        for _ in range(iters):
            a = np.asarray(assign_step(jnp.asarray(C), slj, k))
            flat = slot * k + a
            cnt = np.bincount(flat, minlength=M * k)
            sums = np.empty((M * k, 256), np.int64)
            for b in range(256):
                sums[:, b] = np.bincount(flat, weights=bits[:, b],
                                         minlength=M * k)
            nz = cnt > 0
            med = (sums[nz] * 2 > cnt[nz, None]).astype(np.uint8)
            newC = np.asarray(
                pack_bits(jnp.asarray(med)), np.uint32).reshape(-1, 8)
            Cf = C.reshape(M * k, 8)
            Cf[nz] = newC
            C = Cf.reshape(M, k, 8)
        flat = slot * k + a
        cnt = np.bincount(flat, minlength=M * k)
        nonempty = (cnt > 0).reshape(M, k)

        # allocate child node ids for nonempty clusters (compacted)
        n_children = int(nonempty.sum())
        child_id = np.full((M, k), -1, np.int64)
        child_id[nonempty] = node_base + np.arange(n_children)
        ch_rows = np.full((n_children, k), -1, np.int32)
        centers_out.append(C.reshape(M * k, 8)[nonempty.ravel()])
        children_out.append(ch_rows)
        # fill the parents' children tables (parents are earlier rows)
        parent_rows = np.concatenate(children_out[:-1])
        for m in range(M):
            ids = child_id[m][nonempty[m]]
            parent_rows[level_node_ids[m], :len(ids)] = ids
        # write back split (keep list-of-arrays consistent)
        off = 0
        for i, arr in enumerate(children_out[:-1]):
            children_out[i] = parent_rows[off:off + len(arr)]
            off += len(arr)

        slot = child_id[slot, a] - node_base                 # dense 0..n-1
        level_node_ids = node_base + np.arange(n_children)
        node_base += n_children

    centers = np.concatenate(centers_out)
    children = np.concatenate(children_out)
    n_nodes = len(centers)
    word_id = np.full(n_nodes, -1, np.int32)
    word_id[level_node_ids] = np.arange(len(level_node_ids), dtype=np.int32)
    n_words = len(level_node_ids)

    # idf from document frequency (DBoW2 TF_IDF weighting)
    idf = np.ones(n_words, np.float32)
    if doc_id is not None:
        word_per_desc = word_id[level_node_ids[slot]]
        docs = np.asarray(doc_id)
        n_docs = len(np.unique(docs))
        pairs = np.unique(
            word_per_desc.astype(np.int64) * (docs.max() + 1) + docs)
        df = np.bincount((pairs // (docs.max() + 1)).astype(np.int64),
                         minlength=n_words)
        idf = np.log(n_docs / np.maximum(df, 1)).astype(np.float32)
        idf = np.maximum(idf, 1e-3)
    return Vocabulary(
        centers=jnp.asarray(centers),
        children=jnp.asarray(children),
        word_id=jnp.asarray(word_id),
        idf=jnp.asarray(idf),
        k=k,
        depth=depth,
    )


@partial(jax.jit, static_argnames=("vocab_k", "vocab_depth", "n_words"))
def _transform(centers, children, word_id, idf, desc, valid,
               vocab_k: int, vocab_depth: int, n_words: int):
    N = desc.shape[0]
    node = jnp.zeros((N,), jnp.int32)
    for _ in range(vocab_depth):
        ch = children[node]                                  # [N, k]
        has_child = ch >= 0
        chc = jnp.clip(ch, 0, centers.shape[0] - 1)
        cen = centers[chc]                                   # [N, k, 8]
        d = jnp.sum(
            jax.lax.population_count(jnp.bitwise_xor(cen, desc[:, None, :])),
            axis=-1,
        ).astype(jnp.int32)
        d = jnp.where(has_child, d, 1 << 16)
        best = jnp.argmin(d, axis=-1)
        nxt = jnp.take_along_axis(ch, best[:, None], axis=-1)[:, 0]
        node = jnp.where(nxt >= 0, nxt, node)                # stay on leaf
    w = word_id[node]
    w_ok = valid & (w >= 0)
    hist = jax.ops.segment_sum(
        w_ok.astype(jnp.float32),
        jnp.where(w_ok, jnp.clip(w, 0, n_words - 1), n_words),
        num_segments=n_words + 1,
    )[:n_words]
    v = hist * idf
    norm = jnp.maximum(jnp.sum(jnp.abs(v)), 1e-9)
    return v / norm, jnp.where(w_ok, w, -1)


def bow_vector(vocab: Vocabulary, desc: jnp.ndarray, valid: jnp.ndarray):
    """Frame descriptors [F, 8] -> (tf-idf L1-normalized BoW [n_words],
    per-feature word ids [F]). The word ids are the reference's feature
    vector (used for BoW-bucketed matching if desired)."""
    return _transform(
        vocab.centers, vocab.children, vocab.word_id, vocab.idf,
        desc, valid, vocab.k, vocab.depth, vocab.n_words,
    )


def l1_score(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 similarity: 1 - 0.5*|a-b|_1; broadcasts [.., W] x [.., W]."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(a - b), axis=-1)


class PlaceRecognizer:
    """Keyframe BoW database (PlaceRecognizer.{h,cc} analog): a dense
    [K, n_words] matrix updated on keyframe insertion; queries score against
    all rows in one op. Covisibility-accumulated scoring follows
    detectRelocalizationCandidates: each candidate's score is summed over
    its best covisible neighbors and the best of each group is kept."""

    def __init__(self, vocab: Vocabulary, K: int):
        self.vocab = vocab
        self.kf_bow = jnp.zeros((K, vocab.n_words), jnp.float32)
        self.present = np.zeros(K, bool)

    def add_keyframe(self, k: int, desc, valid):
        v, _ = bow_vector(self.vocab, desc, valid)
        self.kf_bow = self.kf_bow.at[k].set(v)
        self.present[k] = True

    def remove_keyframe(self, k: int):
        self.kf_bow = self.kf_bow.at[k].set(0.0)
        self.present[k] = False

    def scores(self, desc, valid) -> np.ndarray:
        v, _ = bow_vector(self.vocab, desc, valid)
        s = np.array(l1_score(self.kf_bow, v[None, :]))
        s[~self.present] = -1.0
        return s

    def detect_relocalization_candidates(self, desc, valid, covis,
                                         exclude=(), n_max: int = 5):
        s = self.scores(desc, valid)
        for e in exclude:
            s[e] = -1.0
        if (s <= 0).all():
            return []
        # accumulate over covisibility groups (top-10 neighbors)
        cv = np.asarray(covis)
        acc = s.copy()
        for k in np.nonzero(s > 0)[0]:
            nb = np.argsort(-cv[k])[:10]
            acc[k] = s[k] + s[nb][(cv[k][nb] > 0) & (s[nb] > 0)].sum()
        best = float(acc.max())
        keep = np.nonzero(acc >= 0.75 * best)[0]
        order = keep[np.argsort(-acc[keep])]
        return [int(k) for k in order[:n_max]]

    def detect_loop_candidates(self, desc, valid, covis_row, kf_id: int,
                               min_score: float, n_max: int = 5):
        """Loop candidates: scored above min_score (the min BoW similarity
        among the querying KF's covisible neighbors, LoopClosing.cc:119-150)
        and not covisible with it. `covis_row` is the querying KF's row of
        the covisibility matrix ([K]; a full [K,K] matrix also works for
        back-compat — only row kf_id is read)."""
        s = self.scores(desc, valid)
        row = np.asarray(covis_row)
        if row.ndim == 2:
            row = row[kf_id]
        s[kf_id] = -1.0
        s[row > 0] = -1.0  # exclude the covisible neighborhood
        cands = np.nonzero(s >= min_score)[0]
        order = cands[np.argsort(-s[cands])]
        return [int(k) for k in order[:n_max]]
