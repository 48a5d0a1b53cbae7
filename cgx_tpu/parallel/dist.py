"""Distribution: query-data-parallel execution over a ``jax.sharding.Mesh``.

The reference is single-GPU (SURVEY.md section 2.3); queries are embarrassingly
parallel (per-query output files), so the natural scaling axis is the flat
*work-item* axis of every device stage (query tokens for pass 1/2, pattern
occurrences for lookups, sampled occurrences for extraction, rules for MaxLex):

* the corpus index (SA, str, interval-LCP tree, RLP, lex table) is **replicated**
  per device;
* work-item arrays are sharded over the ``"dp"`` mesh axis; each device runs the
  identical vmapped kernel on its shard (no cross-device communication inside a
  stage);
* global statistics (match/rule counts) reduce with ``psum`` inside ``shard_map``.

``make_sharded_search_step`` builds the canonical multi-chip step used by
``__graft_entry__.dryrun_multichip``: pass-1 search + contiguous extraction over
sharded item axes with psum'd counts, jitted over the mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cgx_tpu.search import passes
from cgx_tpu.extract import device as xdev


def make_mesh(n_devices: int = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devices), axis_names=("dp",))


def pad_to_multiple(a: np.ndarray, m: int, fill) -> np.ndarray:
    r = (-len(a)) % m
    if r == 0:
        return a
    return np.concatenate([a, np.full((r,) + a.shape[1:], fill, a.dtype)])


def shard_items(mesh: Mesh, a: np.ndarray, fill=0) -> jax.Array:
    """Pad the item axis to the mesh size and place with a dp sharding."""
    a = pad_to_multiple(np.asarray(a), mesh.devices.size, fill)
    return jax.device_put(a, NamedSharding(mesh, P("dp")))


def replicate(mesh: Mesh, a) -> jax.Array:
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P()))


def make_sharded_search_step(mesh: Mesh, reflen: int, mrs: int, msym: int):
    """jitted (index arrays, token shard, occurrence shard) -> per-shard pass-1
    results, extraction slots and psum'd global counts."""

    def step(refstr, refsa, lcpleft, lcpright, rlp, lr_tar, qtokens,
             toks, suffixlens, sa_pos, lms):
        p1 = jax.vmap(functools.partial(
            passes._pass1_token, refstr, refsa, lcpleft, lcpright, qtokens,
            reflen))(toks, suffixlens)
        cs = refsa[sa_pos]
        ex = jax.vmap(functools.partial(
            xdev._extract_contig_item, refstr, rlp, lr_tar,
            mrs, msym))(cs, lms)
        n_match = jax.lax.psum(jnp.sum(p1[0] > 0), "dp")
        # families come back packed (ts, word) pairs; bit 0 = valid
        n_rules = jax.lax.psum(
            jnp.sum(ex[1] & 1) + jnp.sum(ex[3] & 1) + jnp.sum(ex[5] & 1)
            + jnp.sum(ex[7] & 1), "dp")
        return p1, ex, n_match, n_rules

    from jax.experimental.shard_map import shard_map
    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(),
                  P("dp"), P("dp"), P("dp"), P("dp")),
        out_specs=((P("dp"),) * 6, (P("dp"),) * 8, P(), P()),
        check_rep=False)
    return jax.jit(sharded)


def contig_occurrences(blocks, cfg):
    """Sampled occurrence work list for the contiguous extraction kernel."""
    from cgx_tpu.extract.blocks import sample_indices
    bnums, sa_pos, lms = [], [], []
    for bnum in range(len(blocks.start)):
        lm = int(blocks.matchlen[bnum])
        if lm < 1:
            continue
        b0, b1 = int(blocks.start[bnum]), int(blocks.end[bnum])
        for rel in sample_indices(b1 - b0 + 1, cfg.sampler, cfg.is_sample):
            bnums.append(bnum)
            sa_pos.append(b0 + rel)
            lms.append(lm)
    return (np.asarray(bnums, np.int64), np.asarray(sa_pos, np.int32),
            np.asarray(lms, np.int32))


def run_sharded_search(mesh: Mesh, index, queries, blocks, cfg):
    """Query-DP pass-1 + contiguous extraction over a mesh; returns the pass-1
    longestmatch array (host) plus global counts.  Results for real (non-pad)
    items are identical to the single-chip path."""
    n = queries.totaltokens
    ends = np.array([queries.query_end(int(q)) for q in queries.tok_to_qry],
                    dtype=np.int32)
    toks = np.arange(n, dtype=np.int32)
    suffixlens = ends - toks
    _, sa_pos, lms = contig_occurrences(blocks, cfg)

    step = make_sharded_search_step(mesh, index.reflen, cfg.max_rule_span,
                                    cfg.max_rule_symbols)
    p1, ex, n_match, n_rules = step(
        replicate(mesh, index.refstr_padded), replicate(mesh, index.sa),
        replicate(mesh, index.lcpleft), replicate(mesh, index.lcpright),
        replicate(mesh, index.rlp), replicate(mesh, index.lr_tar),
        replicate(mesh, index.device_query_tokens(queries)),
        shard_items(mesh, toks), shard_items(mesh, suffixlens),
        shard_items(mesh, sa_pos), shard_items(mesh, lms))
    lm_arr = np.asarray(p1[0])[:n]
    return lm_arr, int(n_match), int(n_rules)
