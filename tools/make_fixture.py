"""Generate the hansards-style toy fixture (cdec input format).

The reference README references a ``toy/`` hansards fr-en fixture that is absent from
the mounted snapshot (README.md:57-77); this reconstructs an equivalent deterministic
fixture: source corpus, target corpus, giza-style alignments, cdec lex file
(``src tgt P(s|t) P(t|s)``), and a query file containing in-vocabulary phrases plus
OOVs.  Everything is seeded — regeneration is byte-stable.
"""

from __future__ import annotations

import argparse
import collections
import math
import os
import random


def make_parallel_corpus(rng: random.Random, n_sentences: int):
    # A small bilingual lexicon with ambiguity: each "French" word has 1-2 "English"
    # translations.  Frequent function words ensure the precomputation path triggers.
    n_src_words = 120
    src_words = [f"f{i}" for i in range(n_src_words)]
    tgt_of = {}
    tgt_words = set()
    for i, w in enumerate(src_words):
        opts = [f"e{i}"]
        if rng.random() < 0.3:
            opts.append(f"e{i}x")
        tgt_of[w] = opts
        tgt_words.update(opts)

    # Zipf-ish unigram distribution so some tokens are very frequent.
    weights = [1.0 / (i + 1) ** 0.8 for i in range(n_src_words)]

    f_lines, e_lines, a_lines = [], [], []
    for _ in range(n_sentences):
        slen = rng.randint(3, 12)
        f_sent = rng.choices(src_words, weights=weights, k=slen)
        e_sent = []
        links = []
        for si, fw in enumerate(f_sent):
            r = rng.random()
            if r < 0.08:
                continue  # unaligned source word
            ew = rng.choice(tgt_of[fw])
            e_sent.append(ew)
            links.append((si, len(e_sent) - 1))
            if r > 0.9:  # one-to-many: extra target word aligned to same source
                e_sent.append(rng.choice(tgt_of[fw]))
                links.append((si, len(e_sent) - 1))
        if not e_sent:  # guarantee nonempty target sentence
            ew = rng.choice(tgt_of[f_sent[0]])
            e_sent.append(ew)
            links.append((0, 0))
        # occasional unaligned target insertion
        if rng.random() < 0.25:
            e_sent.append("e_the")
        # local reordering: swap two adjacent target words (and their links)
        if len(e_sent) > 3 and rng.random() < 0.5:
            k = rng.randrange(len(e_sent) - 1)
            e_sent[k], e_sent[k + 1] = e_sent[k + 1], e_sent[k]
            links = [
                (s, (k + 1 if t == k else k if t == k + 1 else t)) for (s, t) in links
            ]
        f_lines.append(" ".join(f_sent))
        e_lines.append(" ".join(e_sent))
        a_lines.append(" ".join(f"{s}-{t}" for (s, t) in links))
    return f_lines, e_lines, a_lines


def make_lex_file(rng: random.Random, f_lines, e_lines, a_lines):
    # Count aligned cooccurrences -> relative-frequency conditional probabilities,
    # like cdec's lex table; plus NULL rows.
    pair = collections.Counter()
    fcount = collections.Counter()
    ecount = collections.Counter()
    for f, e, a in zip(f_lines, e_lines, a_lines):
        fs, es = f.split(), e.split()
        linked_f, linked_e = set(), set()
        for tok in a.split():
            s, t = tok.split("-")
            s, t = int(s), int(t)
            pair[(fs[s], es[t])] += 1
            fcount[fs[s]] += 1
            ecount[es[t]] += 1
            linked_f.add(s)
            linked_e.add(t)
        for i, fw in enumerate(fs):
            if i not in linked_f:
                pair[(fw, "NULL")] += 1
                fcount[fw] += 1
                ecount["NULL"] += 1
        for j, ew in enumerate(es):
            if j not in linked_e:
                pair[("NULL", ew)] += 1
                fcount["NULL"] += 1
                ecount[ew] += 1
    lines = []
    for (fw, ew), c in sorted(pair.items()):
        psgt = c / ecount[ew]   # P(s|t)
        ptgs = c / fcount[fw]   # P(t|s)
        lines.append(f"{fw} {ew} {psgt:.7f} {ptgs:.7f}")
    return lines


def make_queries(rng: random.Random, f_lines, n_queries: int):
    queries = []
    for qi in range(n_queries):
        base = rng.choice(f_lines).split()
        # splice in a phrase from another sentence + an OOV sometimes
        other = rng.choice(f_lines).split()
        cut = rng.randrange(len(base))
        q = base[:cut] + other[: rng.randint(1, 4)] + base[cut:]
        if qi % 3 == 0:
            q.insert(rng.randrange(len(q) + 1), f"oov{qi}")
        queries.append(" ".join(q[:20]))
    return queries


def write(path, lines):
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")


def build(out_dir: str, sentences: int = 300, queries: int = 8,
          seed: int = 20260817) -> str:
    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)
    f_lines, e_lines, a_lines = make_parallel_corpus(rng, sentences)
    lex_lines = make_lex_file(rng, f_lines, e_lines, a_lines)
    q_lines = make_queries(rng, f_lines, queries)
    write(os.path.join(out_dir, "corpus.f"), f_lines)
    write(os.path.join(out_dir, "corpus.e"), e_lines)
    write(os.path.join(out_dir, "corpus.a"), a_lines)
    write(os.path.join(out_dir, "lex.txt"), lex_lines)
    write(os.path.join(out_dir, "query.f"), q_lines)
    return out_dir


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures", "toy"))
    ap.add_argument("--sentences", type=int, default=300)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--seed", type=int, default=20260817)
    args = ap.parse_args()
    build(args.out, args.sentences, args.queries, args.seed)
    print(f"fixture written to {args.out}")


if __name__ == "__main__":
    main()
