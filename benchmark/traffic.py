"""The benchmark's one traffic generator: files cut from a corpus.

A traffic mix is a JSON file under ``traffic/`` that this module reads;
a configuration names the corpus.  The corpus is decoded once with
stdlib ``bz2`` and cut into `chunk_bytes` chunks.  Each file takes the
chunks in an order the seed draws, round and round while it needs more,
and is cut to its size.  Sizes come
from the mix's ladder, the same for every seed: the pool holds
`pool_passes` passes of the ladder, each pass visiting the rungs in an
order the seed draws.  So every seed's window sees the same sizes, and
the seed changes only the bytes and the order.
"""

from __future__ import annotations

import bz2
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_json(kind, name):
    """benchmark/<kind>/<name>.json as a dict."""
    with open(os.path.join(ROOT, kind, name + '.json')) as f:
        return json.load(f)


def rng(seed, *stream):
    """The generator of `seed` (any whole number) for one use, `stream`."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def load_corpus(path):
    """The corpus's bytes: a bzip2 file under benchmark/, decoded."""
    with open(os.path.join(ROOT, path), 'rb') as f:
        return bz2.decompress(f.read())


def chunk_list(corpus, chunk_bytes):
    return [corpus[i:i + chunk_bytes]
            for i in range(0, len(corpus), chunk_bytes)]


def pool_sizes(traffic, seed):
    """[(rung index, bytes)] of the pool, in the order the window visits
    them."""
    ladder = traffic['ladder_bytes']
    r = rng(seed, 1)
    return [(int(k), ladder[k]) for _ in range(traffic['pool_passes'])
            for k in r.permutation(len(ladder))]


def make_pool(corpus, traffic, seed):
    """The pool's files: a list of dicts with 'rung', 'size' and 'data'
    (bytes).  Each file repeats a shuffle of its own of the chunks, so no
    chunk repeats inside any stretch shorter than the corpus, whatever
    the seed: a repeat of a whole chunk inside a block would lengthen the
    block's sort by rounds."""
    chunks = chunk_list(corpus, traffic['chunk_bytes'])
    r = rng(seed, 2)
    files = []
    for rung, size in pool_sizes(traffic, seed):
        once = b''.join(chunks[c] for c in r.permutation(len(chunks)))
        data = once * -(-size // len(once))
        files.append(dict(rung=rung, size=size, data=data[:size]))
    return files

