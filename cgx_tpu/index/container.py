"""GrammarIndex: the device-resident corpus index.

Holds the arrays every device stage reads (token string, suffix array, interval-LCP
tree, RLP, target alignment spans, target string, lexical table) as jnp arrays,
placed once and reused across stages — the reference re-uploads these before every
kernel (e.g. SuffixArray.cu:1396-1412, ExtractPair.cu:3279-3282); we keep them
resident in HBM.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from cgx_tpu.config import ExtractorConfig
from cgx_tpu.preproc.corpus import (Alignment, LexTable, QuerySet, SourceCorpus,
                                    TargetCorpus)
from cgx_tpu.preproc.suffix_array import SAIndex
from cgx_tpu.search import passes


@dataclasses.dataclass
class GrammarIndex:
    reflen: int                  # static corpus token length
    refstr_padded: jnp.ndarray   # int32 [reflen + qry_max + 16]
    sa: jnp.ndarray              # int32 [reflen]
    lcpleft: jnp.ndarray
    lcpright: jnp.ndarray
    rlp: jnp.ndarray             # uint32 [reflen] (+pad) as int64-safe uint32
    l_tar: jnp.ndarray           # int32 [target toklen]
    r_tar: jnp.ndarray
    lr_tar: jnp.ndarray          # int32 (L << 8) | R — one gather serves both
    tgt_str: jnp.ndarray         # int32 [target toklen]
    lex_key: np.ndarray          # int64 [n_lex] packed (src << 32) | (tgt & mask);
                                 # host-side; features.maxlex derives its device
                                 # probe tables (dense matrices or int32 (src,
                                 # tgt) columns) from it, cached per index
    lex_val1: jnp.ndarray        # float32
    lex_val2: jnp.ndarray
    # host mirrors for host-side stages (MaxLex): the originals are built from
    # numpy, so these are free references, not D2H copies
    tgt_str_host: np.ndarray = None
    lex_val1_host: np.ndarray = None
    lex_val2_host: np.ndarray = None
    # the local device this replica is committed to (None = default device);
    # set by parallel.localdp when it replicates the index per device
    device: object = None
    # host seed tables for the refinement search (passes.build_seed_tables):
    # (seed_lo1, seed_hi1, seed_pk, seed_pk3) — answer depths 0-2 on host
    seed_host: tuple = None

    def seed_tables(self):
        return self.seed_host

    def device_query_tokens(self, queries: QuerySet) -> jnp.ndarray:
        # cached on the QuerySet instance (lifetime-tied, no id() aliasing)
        return queries.device_tokens(self.device)

    @property
    def offs0(self):
        """Identity offsets for the replicated layout (utils.views.make_views):
        (src_off, tgt_off, refstr_glen, rlp_glen, lrtar_glen).  Traced scalars
        so programs stay corpus-size-independent (arrays are bucket-padded)."""
        return (np.int32(0), np.int32(0),
                np.int32(self.refstr_padded.shape[0]),
                np.int32(self.rlp.shape[0]), np.int32(self.lr_tar.shape[0]))


@dataclasses.dataclass
class HostLexIndex:
    """The host-side slice of the index that MaxLex scoring reads when it runs
    its host backend (sharded-index mode / pipeline-overlap worker threads /
    small batches); lets sharded-index mode skip materializing any full device
    array.  The replicated pipeline's MaxLex probes run on the chip
    (features.maxlex device backends)."""

    tgt_str_host: np.ndarray
    lex_key: np.ndarray
    lex_val1_host: np.ndarray
    lex_val2_host: np.ndarray


def build_host_lex_index(target: TargetCorpus, lex: LexTable) -> HostLexIndex:
    return HostLexIndex(
        tgt_str_host=np.asarray(target.str_),
        lex_key=pack_lex_key(lex.keys_src, lex.keys_tgt),
        lex_val1_host=np.asarray(lex.val1, dtype=np.float32),
        lex_val2_host=np.asarray(lex.val2, dtype=np.float32))


def pack_lex_key(src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """Order-preserving packing of (src, tgt) int32 pairs into sortable int64:
    matches the (ch, eng) lexicographic comparator (lexFileCompare,
    ExtractPair.cu:28-35).  The +2**31 bias keeps signed tgt order (the -1 NULL id
    must sort before positive ids) in the unsigned low 32 bits."""
    return (np.asarray(src).astype(np.int64) << 32) | (
        np.asarray(tgt).astype(np.int64) + 2**31)


def build_index(source: SourceCorpus, target: TargetCorpus, sa: SAIndex,
                align: Alignment, lex: LexTable,
                cfg: ExtractorConfig) -> GrammarIndex:
    # Invariant used to skip the reference's dead SA-boundary probe (see
    # cgx_tpu.search.passes): the final token is the unique maximum.
    assert int(source.str_[sa.sa[-1]]) == int(source.str_.max()), \
        "corpus must end in the unique sentinel token"
    from cgx_tpu.utils.batching import pad_tokens as _ptk
    refstr_padded = passes.pad_refstr(source.str_, cfg.qry_max_length)
    # pad RLP with unaligned words so right-growth reads past the end are safe
    rlp_padded = np.concatenate([
        align.RLP.astype(np.uint32),
        np.full(cfg.max_rule_span + 2, 0xFFFF0000, dtype=np.uint32)])
    tgt_pad = np.full(cfg.max_rule_span + 2, 255, dtype=np.int32)
    l_tar_np = np.concatenate([align.L_tar.astype(np.int32), tgt_pad])
    r_tar_np = np.concatenate([align.R_tar.astype(np.int32), tgt_pad])
    # bucket-pad every device array to a power of two so every compiled
    # program is corpus-size-independent (shape-stable across corpora; the
    # searches are bounded by the traced logical reflen)
    refstr_padded = _ptk(refstr_padded, np.int32(0))
    rlp_padded = _ptk(rlp_padded, np.uint32(0xFFFF0000))
    l_tar_np = _ptk(l_tar_np, np.int32(255))
    r_tar_np = _ptk(r_tar_np, np.int32(255))
    return GrammarIndex(
        reflen=source.toklen,
        refstr_padded=jnp.asarray(refstr_padded),
        sa=jnp.asarray(_ptk(np.asarray(sa.sa, np.int32), np.int32(0))),
        lcpleft=jnp.asarray(_ptk(np.asarray(sa.lcpleft, np.int32),
                                 np.int32(0))),
        lcpright=jnp.asarray(_ptk(np.asarray(sa.lcpright, np.int32),
                                  np.int32(0))),
        rlp=jnp.asarray(rlp_padded),
        l_tar=jnp.asarray(l_tar_np),
        r_tar=jnp.asarray(r_tar_np),
        lr_tar=jnp.asarray((l_tar_np << 8) | r_tar_np),
        tgt_str=jnp.asarray(target.str_),
        lex_key=pack_lex_key(lex.keys_src, lex.keys_tgt),
        lex_val1=jnp.asarray(lex.val1),
        lex_val2=jnp.asarray(lex.val2),
        tgt_str_host=np.asarray(target.str_),
        lex_val1_host=np.asarray(lex.val1, dtype=np.float32),
        lex_val2_host=np.asarray(lex.val2, dtype=np.float32),
        seed_host=passes.build_seed_tables(refstr_padded,
                                           np.asarray(sa.sa, np.int64)),
    )
