"""CTC prefix beam search (config 4, BASELINE.json:10; SURVEY.md §2.5/§3.5).

Two implementations:

* ``beam_decode_reference`` — exact Hannun-style host prefix beam (the
  oracle; O(T·K·V) Python, eval-scale only).
* ``beam_decode`` — batched ON-DEVICE fixed-width beam: static ``[B, K]``
  hypothesis state inside one jit. Per frame, the K×V extension grid is
  scored on the VPU and duplicate prefixes are merged EXACTLY via
  rolling-hash equality (SURVEY.md §7 hard-part 3). The merge exploits
  two structural facts of prefix beams: (a) two EXTENSIONS can never
  collide (equal-length prefixes of two distinct beams cannot be equal),
  so the only merges are stay(k) ← matching extensions; and (b) the
  extension of parent j that collides with stay k is uniquely
  ``(j, last_k)`` and exists iff ``prefix_j == prefix_k[:-1]`` — so by
  carrying each beam's PARENT-prefix hash alongside its own, the match
  is an O(K²) [B,K,K] equality (double rolling hash, collision
  ~2⁻⁶⁰-rare) and the matched scores are picked by two tiny one-hot
  matmuls — V-independent, where an earlier design burned an
  O(K²·V) [B,K,K·V] masked logsumexp per frame (the fix for
  CSJ-realistic vocabs). The global top-K stays ONE flat
  [B, K + K·V] top_k rather than a per-parent top-P prune (which
  trades B rows for B·K rows; not measured on a GPU).
  Optional n-gram LM shallow fusion uses a
  device-resident dense table + one int32 context id per hypothesis
  (decode/lm.py), scores = log P_am + α·log P_lm + β per emitted char.

Per-utterance lengths freeze the beam past each utterance's last frame —
all shapes static, no host round-trips until detokenization. The
traceback (ancestry chain-follow + prefix compaction) also runs ON
DEVICE (reverse scan + stable sort), so the host never pulls the
[T,B,K] traceback arrays — it receives one packed
[B, keep·max_len + keep] int16 array per batch (keep=1 on the 1-best
paths).
"""

from __future__ import annotations

import math
from collections import OrderedDict, defaultdict

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import BLANK_ID
from .lm import HashedLM, NGramLM

LOG_ZERO = -1.0e30
# DOUBLE rolling hash: two independent (multiplier, modulus) pairs sorted
# as a compound key — int32 arithmetic overflows (wrapping mod 2^32) weaken
# a single hash, but a simultaneous collision in both is ~2^-60-rare.
_HASH_MULT = 1000003
_HASH_MOD = 2**30 - 35          # prime, keeps hashes positive int32
_HASH_MULT2 = 754_877
_HASH_MOD2 = 2**30 - 173        # a different prime


def _lse(a, b):
    if a <= LOG_ZERO / 2:
        return b
    if b <= LOG_ZERO / 2:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


# ---------------------------------------------------------------------------
# host oracle
# ---------------------------------------------------------------------------

def beam_decode_reference(logprobs, length, beam=8, lm: NGramLM | None = None,
                          alpha=0.5, beta=1.0):
    """Exact prefix beam over one utterance. logprobs: [T, V] (log-softmax).

    Returns the best prefix as a list of ids.
    """
    lp = np.asarray(logprobs)
    beams = {(): (0.0, LOG_ZERO)}                   # prefix -> (p_b, p_nb)
    V = lp.shape[1]
    for t in range(int(length)):
        new: dict = defaultdict(lambda: (LOG_ZERO, LOG_ZERO))
        for prefix, (pb, pnb) in beams.items():
            total = _lse(pb, pnb)
            last = prefix[-1] if prefix else None
            # blank: prefix unchanged, mass moves to p_b
            npb, npnb = new[prefix]
            new[prefix] = (_lse(npb, total + lp[t, BLANK_ID]), npnb)
            # repeat last symbol: collapses into same prefix (p_nb path only)
            if last is not None:
                npb, npnb = new[prefix]
                new[prefix] = (npb, _lse(npnb, pnb + lp[t, last]))
            # extensions
            for c in range(1, V):
                base = pb if c == last else total
                if base <= LOG_ZERO / 2:
                    continue
                sc = base + lp[t, c]
                if lm is not None:
                    sc += alpha * lm.score(prefix, c) + beta
                ext = prefix + (c,)
                epb, epnb = new[ext]
                new[ext] = (epb, _lse(epnb, sc))
        beams = dict(sorted(new.items(), key=lambda kv: -_lse(*kv[1]))[:beam])
    best = max(beams.items(), key=lambda kv: _lse(*kv[1]))
    return list(best[0])


# ---------------------------------------------------------------------------
# on-device batched beam
# ---------------------------------------------------------------------------

def beam_decode(logits, lengths, beam: int = 8, lm=None,
                alpha: float = 0.5, beta: float = 1.0,
                max_len: int | None = None, mesh=None, axis=None):
    """Batched on-device prefix beam. logits [B,T,V], lengths [B].

    lm: None, an NGramLM (dense-tensorized automatically), a pre-built
    (dense_table [C,V] np/jnp fp32, order) tuple, or a HashedLM (sparse
    open-addressing device repr — the scalable path for order ≥ 4 or
    large V, where the dense V^(n-1)×V table no longer fits device
    memory).

    Exact (no candidate pruning): the structural merge keeps the full
    K·V extension grid, so results match beam_decode_reference wherever
    the beam is wide enough — see the exhaustive-enumeration test.

    ``mesh``: optional DP mesh — utterances are independent, so the scan
    runs under ``shard_map`` with batch rows split ``P(axis)`` (all chips
    decode instead of one; VERDICT r1 missing #3 extended to beam eval).
    Requires B divisible by the mesh size; results are identical.

    Returns list of per-utterance best-prefix id lists (host side).
    """
    B, T, V = logits.shape
    max_len = max_len or T
    packed, _final = _beam_call(
        logits, lengths, beam, max_len, lm, alpha, beta,
        mesh=mesh, axis=axis, keep=1)
    pfx, plen = _unpack(np.asarray(packed), 1, max_len)
    return [list(pfx[b, 0, : plen[b, 0]]) for b in range(B)]


def _unpack(packed: np.ndarray, keep: int, max_len: int):
    """[B, keep·max_len + keep] int16 → (pfx [B,keep,max_len], plen
    [B,keep]), both widened back to int32 for callers."""
    B = packed.shape[0]
    packed = packed.astype(np.int32)
    pfx = packed[:, : keep * max_len].reshape(B, keep, max_len)
    plen = packed[:, keep * max_len:]
    return pfx, plen


import functools

# identity-keyed LRU memo shared by the LM device paths: repeated
# beam_decode calls (the normal eval loop) must not re-upload the dense
# table / re-densify an NGramLM every batch — each host→device transfer
# costs latency. Entries keep
# the source object referenced so its id() stays a valid key; eviction
# pops only the least-recently-used entry (a blunt clear() would drop a
# hot multi-MB LM table mid-eval and force a full re-upload).
_LM_DEV_CACHE: "OrderedDict[int, tuple]" = OrderedDict()


def _cached_by_identity(obj, build):
    key = id(obj)
    hit = _LM_DEV_CACHE.get(key)
    if hit is not None and hit[0] is obj:
        _LM_DEV_CACHE.move_to_end(key)
        return hit[1]
    val = build(obj)                  # build BEFORE evicting: a failed
    if len(_LM_DEV_CACHE) >= 8:       # build must not cost a hot entry
        _LM_DEV_CACHE.popitem(last=False)
    _LM_DEV_CACHE[key] = (obj, val)
    return val


def _lm_to_device(table) -> jnp.ndarray:
    if isinstance(table, jax.Array) and not isinstance(table, np.ndarray):
        return table.astype(jnp.float32)
    return _cached_by_identity(table, lambda t: jnp.asarray(t, jnp.float32))


def _hashed_to_device(h: HashedLM):
    """(hash table int32 [cap,2], resolved rows [R,V]) on device, cached
    by HashedLM identity. Rows keep their STORAGE dtype (fp32, or fp16
    at CSJ/BPE vocab scale where fp32 rows are GBs — decode/lm.py
    ``device_lm``); the beam casts gathered rows to fp32."""
    return _cached_by_identity(
        h, lambda x: (jnp.asarray(x.table, jnp.int32),
                      jnp.asarray(x.rows)))


def _ngram_to_dense_cached(lm: NGramLM):
    """Densify a raw NGramLM once per object, not once per beam_decode
    call: beam_decode_stream / eval loops pass the same NGramLM for every
    batch, and an uncached to_dense() would rebuild the [V^(n-1), V]
    host table each time — a fresh id() that also defeats _lm_to_device's
    upload cache."""
    return _cached_by_identity(lm, lambda x: x.to_dense())


@functools.lru_cache(maxsize=8)
def _dummy_rows(v: int) -> jnp.ndarray:
    """Stable (cached) placeholder for the unused lm_rows operand on the
    dense / no-LM paths — a fresh zeros() per call would re-upload."""
    return jnp.zeros((1, v), jnp.float32)


@functools.lru_cache(maxsize=64)
def _ab_device(alpha: float, beta: float):
    """(α, β) as ONE cached device array: a fresh host→device transfer
    per call costs latency, and eval loops call with the same fusion
    weights thousands of times."""
    return jnp.asarray([alpha, beta], jnp.float32)


def _beam_call(logits, lengths, beam, max_len, lm, alpha, beta,
               mesh=None, axis=None, keep: int | None = None):
    """Shared jit dispatch: α/β travel as TRACED fp32 scalars so an
    (alpha, beta) grid sweep — the standard config-4 tuning loop — costs
    ONE compile per (shape, beam, lm_order), not one per grid point
    Only the no-LM case keeps a static
    specialization (fuse=False elides the fusion ops entirely).

    Per-call host→device traffic is ONE tiny [2] array (α,β) — the LM
    table is device-cached (_lm_to_device) and results come back as one
    packed int16 array + the final scores.

    ``keep`` (static, default = beam): how many best-first beams the
    traceback resolves and the result packs. The device→host pull
    scales with keep·max_len, so the 1-best path (beam_decode /
    beam_decode_stream) passes keep=1 — a ~K× smaller transfer AND a ~K×
    smaller traceback sort."""
    keep = beam if keep is None else keep
    V = logits.shape[2]
    # the result travels as ONE packed int16 array (token ids ‖ lengths):
    # ids < V and lengths ≤ T must fit int16 or they'd wrap silently
    if V > 32767 or logits.shape[1] > 32767:
        raise ValueError(
            f"beam decode packs results as int16: vocab size {V} and frame "
            f"count {logits.shape[1]} must both be <= 32767")
    (lm_table, lm_rows, lm_order, fuse, hashed, probes,
     alpha, beta) = _prep_lm(lm, V, alpha, beta)
    ab = _ab_device(float(alpha), float(beta))     # cached device scalar pair
    if mesh is not None and mesh.devices.size > 1 \
            and logits.shape[0] % mesh.devices.size == 0:
        # axis defaults to ALL mesh axes so a 2-D (dcn, data) multi-slice
        # mesh splits rows over every chip, not one slice's worth
        from ..parallel.mesh import mesh_axes

        ax = mesh_axes(mesh, axis)
        fn = _sharded_beam(mesh, ax, beam, max_len, lm_order, fuse,
                           hashed, probes, keep)
        return fn(jnp.asarray(logits), jnp.asarray(lengths), lm_table,
                  lm_rows, ab)
    return _beam_decode_jit(
        jnp.asarray(logits), jnp.asarray(lengths), beam, max_len,
        lm_table, lm_rows, lm_order, fuse, hashed, probes, ab, keep)


@functools.lru_cache(maxsize=None)
def _sharded_beam(mesh, axis, beam, max_len, lm_order, fuse, hashed,
                  probes, keep):
    """shard_map-wrapped beam core: rows split over the mesh, LM tables and
    fusion scalars replicated; tracebacks come back assembled global (the
    time axis of tb_* is axis 0, batch is axis 1)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def local(logits, lengths, lm_table, lm_rows, ab):
        return _beam_decode_jit(logits, lengths, beam, max_len,
                                lm_table, lm_rows, lm_order, fuse,
                                hashed, probes, ab, keep)

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P()),
        out_specs=(P(axis), P(axis)),
        check_vma=False))


def beam_stream_init(B: int, beam: int, ctx_len: int = 1):
    """Fresh beam-search carry state for B utterances (the scan carry of
    ``_beam_decode_jit``, exposed so decode/streaming.py can thread it
    across chunk boundaries — the prefix-beam recursion is strictly
    causal in t, so chunked decoding with carried state is EXACT).

    ``ctx_len`` = max(lm_order − 1, 1): the LM context travels as the
    hypothesis's last ``ctx_len`` chars (oldest first, zeros = BOS) —
    the dense table index and the hashed level keys are both derived
    from this window per step (decode/lm.py ``ctx_keys``), which frees
    the vocabulary from the old V^order < 2^31 rolled-id bound.

    ``phashes``/``phashes2`` carry the hash of each beam's prefix MINUS
    its last char (the parent prefix at creation time): a stay inherits
    them, an extension takes its parent's own hashes — which makes the
    duplicate-merge an O(K²) check (module docstring). Sentinels are
    disjoint from the hash sentinels (-1..-K) so a dead beam can never
    spuriously match as a merge parent; real rolled hashes are ≥ 0."""
    K = beam
    pb = jnp.full((B, K), LOG_ZERO, jnp.float32).at[:, 0].set(0.0)
    pnb = jnp.full((B, K), LOG_ZERO, jnp.float32)
    hashes = jnp.broadcast_to(-jnp.arange(1, K + 1, dtype=jnp.int32)[None],
                              (B, K)).at[:, 0].set(1)
    hashes2 = jnp.broadcast_to(-jnp.arange(1, K + 1, dtype=jnp.int32)[None],
                               (B, K)).at[:, 0].set(2)
    phashes = jnp.broadcast_to(
        -jnp.arange(K + 1, 2 * K + 1, dtype=jnp.int32)[None], (B, K))
    phashes2 = jnp.broadcast_to(
        -jnp.arange(K + 1, 2 * K + 1, dtype=jnp.int32)[None], (B, K))
    last = jnp.zeros((B, K), jnp.int32)               # 0 = none
    ctx = jnp.zeros((B, K, ctx_len), jnp.int32)       # LM context window
    return pb, pnb, hashes, hashes2, phashes, phashes2, last, ctx


def _prep_lm(lm, V, alpha, beta):
    """Shared LM-argument preparation (dense / hashed / none) for the
    offline and streaming beam entry points: returns
    (lm_table, lm_rows, lm_order, fuse, hashed, probes, alpha, beta)
    with device caching exactly as _beam_call historically did."""
    if isinstance(lm, NGramLM):
        lm = _ngram_to_dense_cached(lm)
    hashed, probes = False, 0
    if isinstance(lm, HashedLM):               # sparse open-addressing repr
        lm_table, lm_rows = _hashed_to_device(lm)
        lm_order, fuse = lm.order, True
        hashed, probes = True, lm.max_probes
    elif lm is not None:
        lm_table, lm_order, fuse = _lm_to_device(lm[0]), int(lm[1]), True
        lm_rows = _dummy_rows(V)
    else:                       # no LM ⇒ no fusion score, no length bonus
        lm_table, lm_order, fuse = _dummy_rows(V), 1, False
        lm_rows = _dummy_rows(V)
        alpha = beta = 0.0
    return lm_table, lm_rows, lm_order, fuse, hashed, probes, alpha, beta


def _beam_step(state, lp, t, lengths, *, K, V, lm_table, lm_rows,
               lm_order, fuse, hashed, probes, alpha, beta):
    """One prefix-beam frame (the body of the offline scan AND of the
    streaming chunk scan): state is the [B,K] carry tuple from
    ``beam_stream_init``; returns (new_state, (tb_parent, tb_char))."""
    pb, pnb, hashes, hashes2, phashes, phashes2, last, ctx = state
    B = pb.shape[0]
    v_ids = jnp.arange(V, dtype=jnp.int32)[None, None, :]   # [1,1,V]
    total = jnp.logaddexp(jnp.maximum(pb, LOG_ZERO), pnb)
    total = jnp.where(jnp.maximum(pb, pnb) <= LOG_ZERO / 2, LOG_ZERO, total)

    # ---- candidate grid [B, K, V]: v==0 stay, v>=1 extend ----------
    # NO per-element gathers anywhere in this body (a design carried
    # over from the first target; a gather version is not measured on
    # the GPU) — every selection is a one-hot mask + sum
    lp_b = lp[:, None, :]                          # [B,1,V]
    eq_last = v_ids == last[:, :, None]            # [B,K,V] one-hot(last)
    # stay: pb' = total + lp[blank]; pnb' = pnb + lp[last] (if last>0)
    stay_pb = total + lp[:, BLANK_ID][:, None]     # [B,K]
    rep = jnp.sum(jnp.where(eq_last, lp_b, 0.0), axis=2)
    stay_pnb = jnp.where(last > 0, pnb + rep, LOG_ZERO)
    # extend: base = (v==last ? pb : total) + lp[v] (+ LM)
    base = jnp.where(eq_last, pb[:, :, None], total[:, :, None])
    ext_pnb = base + lp_b                          # [B,K,V]
    # fusion whenever an LM was passed (fuse is static; α/β are traced
    # scalars): a unigram LM with alpha=0, beta!=0 must still apply
    # the insertion bonus, matching beam_decode_reference
    if fuse and hashed:
        # sparse LM (decode/lm.py::HashedLM): find the resolved score
        # row for the hypothesis context by probing the open-addressing
        # hash LONGEST-SUFFIX-FIRST — level k is keyed by the double
        # window hash of the last k context chars (decode/lm.py
        # ``ctx_keys``: key1 = wrapping positional fold == exact numeric
        # id while V^k < 2^31; key2 = independent verifier); the first
        # level that hits owns the row (exactly score()'s backoff
        # descent, which adds zero weight through unknown contexts).
        # Unknown everywhere → rows[0] (empty context). All levels ×
        # probe slots fold into ONE [B,K,L·P,3] gather (instead of 6
        # separate per-level gathers); priority = first hit in
        # the longest-level-first flattened order via argmax-of-bool.
        # Build guarantees every key lands within ``probes`` slots of
        # its home slot, so the probe window is a static shape.
        from .lm import _CTX_MOD2, _CTX_MULT2
        cap = lm_table.shape[0]                    # power of two
        mask = jnp.uint32(cap - 1)
        p_iota = jnp.arange(probes, dtype=jnp.uint32)
        L = lm_order - 1
        k1s, k2s = [], []
        for k in range(L, 0, -1):                  # longest first
            h1 = jnp.zeros_like(last)
            h2 = jnp.zeros_like(last)
            for lane in range(L - k, L):           # oldest char first
                c = ctx[:, :, lane]
                h1 = h1 * V + c                    # int32 wrap == ctx_keys
                h2 = (h2 * _CTX_MULT2 + c) % _CTX_MOD2
            k1s.append(h1)
            k2s.append(h2)
        key1 = jnp.stack(k1s, axis=-1)             # [B,K,L]
        key2 = jnp.stack(k2s, axis=-1)
        slot0 = (key1.astype(jnp.uint32) * jnp.uint32(2654435761)) & mask
        slots = ((slot0[..., None] + p_iota) & mask) \
            .astype(jnp.int32).reshape(B, K, L * probes)
        tkv = lm_table[slots]                      # [B,K,L·P,3]
        kk1 = jnp.repeat(key1, probes, axis=-1)    # [B,K,L·P]
        kk2 = jnp.repeat(key2, probes, axis=-1)
        hit = ((tkv[..., 0] == kk1) & (tkv[..., 1] == kk2)
               & ((kk1 != 0) | (kk2 != 0)))
        first = jnp.argmax(hit, axis=-1)           # longest-level hit
        oh = first[..., None] == jnp.arange(L * probes)
        val = jnp.sum(jnp.where(oh, tkv[..., 2], 0), axis=-1)
        ridx = jnp.where(jnp.any(hit, axis=-1), val, 0)
        ext_pnb = ext_pnb + alpha * lm_rows[ridx].astype(jnp.float32) + beta
    elif fuse:
        # dense table: context id = positional fold over the window
        # (oldest char highest stride — to_dense's convention); the
        # dense table's existence bounds V^(order-1) · V · 4 bytes, so
        # the fold cannot overflow int32
        if lm_order > 1:
            cid = ctx[:, :, 0]
            for lane in range(1, lm_order - 1):
                cid = cid * V + ctx[:, :, lane]
        else:
            cid = jnp.zeros_like(last)
        lm_row = lm_table[cid]                     # [B,K,V]
        ext_pnb = ext_pnb + alpha * lm_row + beta
    ext_pnb = jnp.where(v_ids == 0, LOG_ZERO, ext_pnb)

    # ---- merge duplicates (structural, O(K²), V-independent) ---------
    # Two extensions can never form the same prefix (equal-length
    # prefixes of two distinct beams cannot be equal), so the ONLY
    # merges are stay(k) ← ext(j, c) with prefix_k == prefix_j + c —
    # which forces c == last_k and prefix_j == prefix_k[:-1]. The
    # carried parent-hashes make that a [B, K_stay, K_parent] double-
    # hash equality; the matched extension scores ext_pnb[b, j, last_k]
    # are picked by a tiny one-hot matmul (fp32-exact under HIGHEST —
    # a one-hot row picks a single fp32 entry, nothing accumulates).
    match = ((phashes[:, :, None] == hashes[:, None, :])
             & (phashes2[:, :, None] == hashes2[:, None, :])
             & (last > 0)[:, :, None])             # [B,K_stay,K_parent]
    el_f = eq_last.astype(jnp.float32)             # one-hot(last) [B,K,V]
    contrib = jnp.einsum("bjv,bkv->bkj", ext_pnb, el_f,
                         precision=jax.lax.Precision.HIGHEST)
    mval = jnp.where(match, contrib, LOG_ZERO)     # [B,K,K]
    mmax = jnp.max(mval, axis=2)                   # [B,K]
    mmax_s = jnp.maximum(mmax, LOG_ZERO / 2)
    msum = jnp.sum(jnp.exp(mval - mmax_s[:, :, None]), axis=2)
    merged = jnp.where(mmax <= LOG_ZERO / 2, LOG_ZERO,
                       mmax_s + jnp.log(jnp.maximum(msum, 1e-37)))
    stay_pnb = jnp.logaddexp(jnp.maximum(stay_pnb, LOG_ZERO),
                             jnp.maximum(merged, LOG_ZERO))
    stay_pnb = jnp.where(stay_pnb <= LOG_ZERO / 2, LOG_ZERO, stay_pnb)
    # consumed extensions live on in their stay beam, not as candidates:
    # ext (j, v) is consumed iff some stay k matched parent j with
    # last_k == v — one more one-hot matmul
    cons = jnp.einsum("bkj,bkv->bjv", match.astype(jnp.float32), el_f,
                      precision=jax.lax.Precision.HIGHEST) > 0.5
    ext_score = jnp.where(cons, LOG_ZERO, ext_pnb).reshape(B, K * V)

    # ---- top-K over K stays + K·V surviving extensions ---------------
    # ONE flat top_k over [B, K + K·V] (B rows, not B·K rows of a
    # per-parent top-P prune)
    stay_score = jnp.logaddexp(jnp.maximum(stay_pb, LOG_ZERO / 2),
                               jnp.maximum(stay_pnb, LOG_ZERO / 2))
    score = jnp.concatenate([stay_score, ext_score], axis=1)
    top_score, top_idx = jax.lax.top_k(score, K)   # [B,K]
    is_stay = top_idx < K
    e_idx = jnp.maximum(top_idx - K, 0)
    # every selected candidate is (parent beam, char): stays are
    # (own index, -1), extensions decode arithmetically from e_idx
    n_parent = jnp.where(is_stay, jnp.minimum(top_idx, K - 1),
                         e_idx // V)
    n_char = jnp.where(is_stay, -1, e_idx % V)

    # one-hot payload selection over the K parents — [B,K,K], tiny.
    # Extensions need NO payload lookup at all: a selected extension's
    # score IS its p_nb (top_score), its p_b is -inf, and its hash
    # rolls arithmetically from the parent's.
    oh_parent = n_parent[:, :, None] == jnp.arange(K, dtype=jnp.int32)
    sel_p_f = lambda x: jnp.sum(
        jnp.where(oh_parent, x[:, None, :], 0.0), axis=2)
    sel_p_i = lambda x: jnp.sum(
        jnp.where(oh_parent, x[:, None, :], 0), axis=2)

    n_pb = jnp.where(is_stay, sel_p_f(stay_pb), LOG_ZERO)
    n_pnb = jnp.where(is_stay, sel_p_f(stay_pnb), top_score)
    # hashes roll arithmetically from the parent's hash — no gather
    # into any [B,K,V] hash grid needed; an extension's parent-hash IS
    # the parent's own hash, a stay inherits the parent's parent-hash
    p_hash = sel_p_i(hashes)
    p_hash2 = sel_p_i(hashes2)
    n_hash = jnp.where(
        is_stay, p_hash,
        ((p_hash % _HASH_MOD) * _HASH_MULT + n_char) % _HASH_MOD)
    n_hash2 = jnp.where(
        is_stay, p_hash2,
        ((p_hash2 % _HASH_MOD2) * _HASH_MULT2 + n_char) % _HASH_MOD2)
    n_phash = jnp.where(is_stay, sel_p_i(phashes), p_hash)
    n_phash2 = jnp.where(is_stay, sel_p_i(phashes2), p_hash2)

    # ---- small per-beam bookkeeping (prefixes are reconstructed from
    # the (parent, char) traceback on the host after the scan) ---------
    extend = n_char >= 0
    new_last = jnp.where(extend, n_char, sel_p_i(last))
    # context window: one-hot parent selection per lane, then on extend
    # shift the window left and append the new char
    new_ctx = jnp.sum(
        jnp.where(oh_parent[..., None], ctx[:, None, :, :], 0), axis=2)
    if lm_order > 1:
        shifted = jnp.concatenate(
            [new_ctx[:, :, 1:], jnp.maximum(n_char, 0)[:, :, None]],
            axis=2)
        new_ctx = jnp.where(extend[:, :, None], shifted, new_ctx)

    # ---- freeze past utterance end -------------------------------------
    alive = (t < lengths)[:, None]
    sel = lambda n, o: jnp.where(
        alive.reshape((B,) + (1,) * (n.ndim - 1)), n, o)
    k_ident = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None], (B, K))
    tb_parent = jnp.where(alive, n_parent, k_ident)   # frozen: identity
    tb_char = jnp.where(alive, n_char, -1)            # frozen: no symbol
    return ((sel(n_pb, pb), sel(n_pnb, pnb), sel(n_hash, hashes),
             sel(n_hash2, hashes2), sel(n_phash, phashes),
             sel(n_phash2, phashes2), sel(new_last, last),
             sel(new_ctx, ctx)),
            (tb_parent, tb_char))


@functools.partial(jax.jit, static_argnames=("beam", "max_len", "lm_order",
                                              "fuse", "hashed", "probes",
                                              "keep"))
def _beam_decode_jit(logits, lengths, beam, max_len, lm_table, lm_rows,
                     lm_order, fuse, hashed, probes, ab, keep=None):
    keep = beam if keep is None else keep
    B, T, V = logits.shape
    K = beam
    alpha, beta = ab[0], ab[1]
    lp_all = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    state0 = beam_stream_init(B, K, max(lm_order - 1, 1))

    def step(state, xs):
        lp, t = xs                                     # [B,V], scalar
        return _beam_step(state, lp, t, lengths, K=K, V=V,
                          lm_table=lm_table, lm_rows=lm_rows,
                          lm_order=lm_order, fuse=fuse, hashed=hashed,
                          probes=probes, alpha=alpha, beta=beta)

    lp_tm = jnp.swapaxes(lp_all, 0, 1)                 # [T,B,V]
    ts = jnp.arange(T, dtype=jnp.int32)
    (pb, pnb, *_rest), (tb_parent, tb_char) = jax.lax.scan(
        step, state0, (lp_tm, ts))

    final = jnp.logaddexp(jnp.maximum(pb, LOG_ZERO / 2),
                          jnp.maximum(pnb, LOG_ZERO / 2))
    order = jnp.argsort(-final, axis=1)                # [B, K] best-first
    final = jnp.take_along_axis(final, order, axis=1)

    # ---- ON-DEVICE traceback ------------------------------------------
    # A host traceback must first PULL the two [T,B,K] traceback arrays.
    # Resolving ancestry and compacting prefixes here means the host
    # receives only the tiny
    # [B,keep,max_len] result. Chain-follow is a reverse scan with one-hot
    # parent selection (gather-free, like the forward scan); compaction is
    # a stable sort that moves each chain's emissions to the front. Only
    # the best ``keep`` chains are followed — the 1-best path never pays
    # for the other K-1 beams' sort lanes or transfer bytes.
    k_iota = jnp.arange(K, dtype=jnp.int32)

    def back(cur, tb):
        tbp_t, tbc_t = tb                              # [B,K] each
        oh = cur[:, :, None] == k_iota                 # [B,keep,K_src]
        ch = jnp.sum(jnp.where(oh, tbc_t[:, None, :], 0), axis=2)
        nxt = jnp.sum(jnp.where(oh, tbp_t[:, None, :], 0), axis=2)
        return nxt, ch

    # reverse=True: consume t = T-1..0 carrying the beam index backwards,
    # stacking each step's emission at its own t → chars[t,b,k] is the
    # symbol emitted at step t on final beam (b,k)'s ancestry (or -1)
    _, chars = jax.lax.scan(back, order[:, :keep], (tb_parent, tb_char),
                            reverse=True)
    valid = chars >= 0                                 # [T,B,keep]
    pos = jnp.cumsum(valid.astype(jnp.int32), axis=0) - 1
    plen = jnp.minimum(jnp.sum(valid, axis=0), max_len).astype(jnp.int32)
    # stable ascending sort by (invalid-goes-last, emission index): valid
    # entries keep their order at keys 0..n-1, pads get keys T+t
    key = jnp.where(valid, pos, T + ts[:, None, None])
    key_t = jnp.moveaxis(key, 0, -1)                   # [B,keep,T]
    chars_t = jnp.moveaxis(chars, 0, -1)
    _, sorted_chars = jax.lax.sort((key_t, chars_t), dimension=-1, num_keys=1)
    m = min(max_len, T)
    pfx = sorted_chars[..., :m]
    if max_len > T:
        pfx = jnp.pad(pfx, ((0, 0), (0, 0), (0, max_len - T)),
                      constant_values=-1)
    pfx = jnp.where(jnp.arange(max_len) < plen[:, :, None], pfx, -1)
    # ONE packed int16 result array: [B, keep·max_len + keep] = prefixes
    # ‖ lens — chars (< V ≤ 32k), -1 pads and lens (≤ T) all fit int16,
    # halving the pull bytes; a second device→host pull per batch would
    # be pure latency
    packed = jnp.concatenate([pfx.reshape(B, keep * max_len), plen],
                             axis=1).astype(jnp.int16)
    return packed, final


@jax.jit
def _stack_jit(*xs):
    return jnp.stack(xs)


def beam_decode_stream(batches, beam: int = 8, lm=None,
                       alpha: float = 0.5, beta: float = 1.0,
                       max_len: int | None = None, mesh=None,
                       axis=None, flush_every: int = 8):
    """Pipelined beam decode over an iterable of (logits, lengths) pairs
    — the bulk-decode path (dev-set eval, corpus transcription).

    Per-batch synchronous decode pays one device→host pull latency per
    batch, capping ``beam_decode`` at ~1/latency batches/s however fast
    the kernel is. This generator keeps up to ``flush_every`` batches in flight and
    drains them with ONE stacked transfer per group, so the pull latency
    amortizes across the group while dispatches pipeline on device.

    Yields one list of per-utterance id-lists per input batch, in input
    order (results for a group arrive when the group flushes). Batches
    of differing [B,T,V] shapes are allowed — a shape change flushes the
    current group (callers iterate per-bucket streams, so groups stay
    full in practice).
    """
    pending: list = []                 # packed device arrays, same shape
    pend_meta: tuple | None = None     # (B, eff_max_len)

    def drain():
        # jitted stack (cached per group size): a bare jnp.stack re-traces
        # on every call — measured ~150 ms of host time per group at
        # flush=8, 3× the group's entire device work
        stacked = np.asarray(_stack_jit(*pending))    # ONE transfer
        for row in stacked:
            pfx, plen = _unpack(row, 1, pend_meta[1])
            yield [list(pfx[b, 0, : plen[b, 0]]) for b in range(pend_meta[0])]
        pending.clear()

    for logits, lengths in batches:
        B, T, V = logits.shape
        eff = max_len or T
        if pending and pend_meta != (B, eff):
            yield from drain()
        pend_meta = (B, eff)
        packed, _final = _beam_call(logits, lengths, beam, eff, lm,
                                    alpha, beta, mesh=mesh, axis=axis,
                                    keep=1)
        pending.append(packed)
        if len(pending) >= flush_every:
            yield from drain()
    if pending:
        yield from drain()


def beam_decode_nbest(logits, lengths, beam: int = 8, lm=None,
                      alpha: float = 0.5, beta: float = 1.0,
                      max_len: int | None = None, mesh=None,
                      axis=None):
    """n-best variant: -> (pfx [B,K,max_len], plen [B,K], scores [B,K]).

    Takes the same ``mesh`` as ``beam_decode`` so n-best decode also
    splits rows over the DP mesh instead of serializing on one chip."""
    B, T, V = logits.shape
    max_len = max_len or T
    packed, final = _beam_call(
        logits, lengths, beam, max_len, lm, alpha, beta,
        mesh=mesh, axis=axis)
    pfx, plen = _unpack(np.asarray(packed), beam, max_len)
    return pfx, plen, np.asarray(final)


# ---------------------------------------------------------------------------
# streaming (chunk-carried) beam — decode/streaming.py's decoder="beam"
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("beam", "lm_order", "fuse",
                                             "hashed", "probes"))
def _beam_chunk_jit(logits, n_valid, state, beam, lm_table, lm_rows,
                    lm_order, fuse, hashed, probes, ab):
    """One streaming chunk of the prefix beam: scan ``logits [B,Cs,V]``
    with the carried ``state`` (see ``beam_stream_init``), resolve the
    IN-CHUNK traceback on device, and return (packed, final, new_state)
    where packed int16 = chunk emissions [B,K·Cs] ‖ emission counts
    [B,K] ‖ parent beam index at chunk start [B,K]. The recursion is
    strictly causal, so chaining chunks reproduces the offline beam
    bit-exactly on the same logits."""
    B, Cs, V = logits.shape
    K = beam
    alpha, beta = ab[0], ab[1]
    lp_all = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)

    def step(st, xs):
        lp, t = xs                                     # [B,V], scalar
        return _beam_step(st, lp, t, n_valid, K=K, V=V,
                          lm_table=lm_table, lm_rows=lm_rows,
                          lm_order=lm_order, fuse=fuse, hashed=hashed,
                          probes=probes, alpha=alpha, beta=beta)

    lp_tm = jnp.swapaxes(lp_all, 0, 1)                 # [Cs,B,V]
    ts = jnp.arange(Cs, dtype=jnp.int32)
    state, (tb_parent, tb_char) = jax.lax.scan(step, state, (lp_tm, ts))

    # in-chunk traceback for ALL K beams (identity start: beam k at chunk
    # end stays slot k — carried state is positional), same gather-free
    # reverse scan + compaction sort as the offline traceback
    k_iota = jnp.arange(K, dtype=jnp.int32)

    def back(cur, tb):
        tbp_t, tbc_t = tb                              # [B,K] each
        oh = cur[:, :, None] == k_iota                 # [B,K,K_src]
        ch = jnp.sum(jnp.where(oh, tbc_t[:, None, :], 0), axis=2)
        nxt = jnp.sum(jnp.where(oh, tbp_t[:, None, :], 0), axis=2)
        return nxt, ch

    cur0 = jnp.broadcast_to(k_iota[None], (B, K))
    parent0, chars = jax.lax.scan(back, cur0, (tb_parent, tb_char),
                                  reverse=True)        # chars: [Cs,B,K]
    valid = chars >= 0
    pos = jnp.cumsum(valid.astype(jnp.int32), axis=0) - 1
    elen = jnp.sum(valid, axis=0).astype(jnp.int32)    # [B,K]
    key = jnp.where(valid, pos, Cs + ts[:, None, None])
    key_t = jnp.moveaxis(key, 0, -1)                   # [B,K,Cs]
    chars_t = jnp.moveaxis(chars, 0, -1)
    _, sorted_chars = jax.lax.sort((key_t, chars_t), dimension=-1, num_keys=1)
    final = jnp.logaddexp(jnp.maximum(state[0], LOG_ZERO / 2),
                          jnp.maximum(state[1], LOG_ZERO / 2))
    packed = jnp.concatenate(
        [sorted_chars.reshape(B, K * Cs),
         elen.astype(jnp.int32), parent0], axis=1).astype(jnp.int16)
    return packed, final, state


class BeamStreamDecoder:
    """Incremental prefix-beam over chunked log-probabilities: device
    state carried across chunks, per-beam token lists chained on the
    host, and tokens FINALIZED once shared by every live beam (the
    common live-beam prefix is monotone: every live candidate's base
    score is finite, so its parent was live and already carried the
    prefix — finalized tokens can never be retracted).

    >>> dec = BeamStreamDecoder(batch, beam=8, lm=lm)
    >>> for chunk_logits, n_valid in chunks:       # [B,Cs,V], [B]
    ...     newly_final = dec.step(chunk_logits, n_valid)
    >>> best = dec.finish()                        # full 1-best id lists
    """

    def __init__(self, batch: int, beam: int = 8, lm=None,
                 alpha: float = 0.5, beta: float = 1.0):
        self.batch, self.beam = batch, beam
        self._lm, self._alpha, self._beta = lm, alpha, beta
        self._state = None
        self._lists = [[[] for _ in range(beam)] for _ in range(batch)]
        self._done = [0] * batch           # finalized tokens per stream
        self._final = None                 # device [B,K] scores, last chunk

    def step(self, logits, n_valid) -> list[list[int]]:
        """Advance by one chunk ([B, Cs, V] logits, [B] valid frame
        counts); returns the ids newly finalized per stream."""
        B, Cs, V = logits.shape
        if B != self.batch:
            raise ValueError(f"expected batch {self.batch}, got {B}")
        if V > 32767 or Cs > 32767:
            raise ValueError("streaming beam packs results as int16: "
                             f"vocab {V} and chunk {Cs} must be <= 32767")
        (lm_table, lm_rows, lm_order, fuse, hashed, probes,
         alpha, beta) = _prep_lm(self._lm, V, self._alpha, self._beta)
        ab = _ab_device(float(alpha), float(beta))
        self._ctx_len = max(lm_order - 1, 1)
        if self._state is None:
            self._state = beam_stream_init(B, self.beam, self._ctx_len)
        packed, final, self._state = _beam_chunk_jit(
            jnp.asarray(logits), jnp.asarray(n_valid, jnp.int32),
            self._state, self.beam, lm_table, lm_rows, lm_order, fuse,
            hashed, probes, ab)
        self._final = final
        K = self.beam
        arr = np.asarray(packed).astype(np.int32)      # ONE small pull
        chars = arr[:, : K * Cs].reshape(B, K, Cs)
        elen = arr[:, K * Cs : K * Cs + K]
        parent0 = arr[:, K * Cs + K :]
        fin = np.asarray(final)
        new: list[list[int]] = []
        for b in range(B):
            old = self._lists[b]
            self._lists[b] = [old[parent0[b, k]]
                              + chars[b, k, : elen[b, k]].tolist()
                              for k in range(K)]
            live = [k for k in range(K) if fin[b, k] > LOG_ZERO / 4]
            common = self._lists[b][live[0]] if live else []
            for k in live[1:]:
                other = self._lists[b][k]
                n = 0
                for x, y in zip(common, other):
                    if x != y:
                        break
                    n += 1
                common = common[:n]
            new.append(common[self._done[b]:])
            self._done[b] += len(new[-1])
        return new

    def finish(self) -> list[list[int]]:
        """Best full hypothesis per stream (superset of everything the
        ``step`` calls finalized)."""
        if self._final is None:
            return [[] for _ in range(self.batch)]
        fin = np.asarray(self._final)
        return [list(self._lists[b][int(np.argmax(fin[b]))])
                for b in range(self.batch)]

    def end_rows(self, rows) -> dict:
        """Utterance boundary (endpointing) for the given stream rows:
        returns {row: 1-best tail beyond the already-finalized tokens}
        and re-initializes those rows' beam state + host lists for the
        next utterance; other rows are untouched."""
        if self._state is None or not rows:
            return {b: [] for b in rows}
        fin = np.asarray(self._final)
        tails = {}
        for b in rows:
            best = self._lists[b][int(np.argmax(fin[b]))]
            tails[b] = best[self._done[b]:]
            self._lists[b] = [[] for _ in range(self.beam)]
            self._done[b] = 0
        mask = np.zeros((self.batch,), bool)
        mask[list(rows)] = True
        m = jnp.asarray(mask)
        init = beam_stream_init(self.batch, self.beam,
                                getattr(self, "_ctx_len", 1))
        self._state = tuple(
            jnp.where(m.reshape((self.batch,) + (1,) * (i.ndim - 1)), i, s)
            for i, s in zip(init, self._state))
        init_final = jnp.logaddexp(jnp.maximum(init[0], LOG_ZERO / 2),
                                   jnp.maximum(init[1], LOG_ZERO / 2))
        self._final = jnp.where(m[:, None], init_final, self._final)
        return tails
