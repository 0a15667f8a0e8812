"""mxnet_tpu_torch.serving.kvcache against the JAX package (CPU).

One sequence of ``reserve`` / ``match_prefix`` + ``admit_prefix`` /
``insert_prefix`` / ``free`` / ``shed_cached`` / ``write_slots`` calls is
driven through both caches; after every call the host state — page
tables, lengths, refcounts, the free list, the cached LRU, per-slot page
counts — must be equal, and so must the pool contents after the same
``write_kv`` rows (exactly: a write is a copy, no arithmetic).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.serving import kvcache as jkv
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import kvcache as tkv

_KW = dict(num_slots=3, max_seq_len=64, num_layers=2, num_kv_heads=2,
           head_dim=4, page_size=8, prefix_cache=True)


class _Pair:
    """The JAX cache and the port's, driven in lockstep."""

    def __init__(self, num_pages, rng):
        name = "kvpair-%d" % rng.randint(1 << 30)
        self.j = jkv.PagedKVCache(num_pages=num_pages, name=name, **_KW)
        self.t = tkv.PagedKVCache(num_pages=num_pages, name=name + "-t",
                                  device="cpu", **_KW)
        self.rng = rng

    def both(self, method, *args):
        """Call ``method`` on both; results (or the raised error type)
        must agree."""
        out = []
        for cache in (self.j, self.t):
            try:
                out.append(("ok", getattr(cache, method)(*args)))
            except Exception as exc:  # noqa: BLE001 - each package's own
                out.append(("err", type(exc).__name__))  # error classes
        assert out[0][0] == out[1][0], (method, args, out)
        if out[0][0] == "err":
            assert out[0] == out[1], (method, args, out)
        self.check()
        return out[0][1]

    def admit(self, slot, prompt, total):
        mj = self.j.match_prefix(prompt)
        mt = self.t.match_prefix(prompt)
        assert (mj is None) == (mt is None)
        if mj is not None:
            assert (mj.matched, mj.partial_len, [e.page for e in mj.full]) \
                == (mt.matched, mt.partial_len, [e.page for e in mt.full])
        rj = self.j.admit_prefix(slot, total, mj)
        rt = self.t.admit_prefix(slot, total, mt)
        assert rj == rt
        _m, src, dst = rj
        if src is not None:  # the engine's copy-on-write device copy
            self.j.k_pool = self.j.k_pool.at[:, dst].set(self.j.k_pool[:, src])
            self.j.v_pool = self.j.v_pool.at[:, dst].set(self.j.v_pool[:, src])
            for pool in (self.t.k_pool, self.t.v_pool):
                pool[:, dst].copy_(pool[:, src])
        self.check()
        return rj

    def write(self, slot, start, n, layer):
        pj = self.j.write_slots(slot, start, n)
        pt = self.t.write_slots(slot, start, n)
        for a, b in zip(pj, pt):
            np.testing.assert_array_equal(a, b)
        rows_k = self.rng.randn(n, 2, 4).astype(np.float32)
        rows_v = self.rng.randn(n, 2, 4).astype(np.float32)
        self.j.k_pool, self.j.v_pool = jkv.write_kv(
            self.j.k_pool, self.j.v_pool, layer, jnp.asarray(rows_k),
            jnp.asarray(rows_v), jnp.asarray(pj[0]), jnp.asarray(pj[1]))
        tkv.write_kv(self.t.k_pool, self.t.v_pool, layer,
                     torch.from_numpy(rows_k), torch.from_numpy(rows_v),
                     torch.from_numpy(pt[0]), torch.from_numpy(pt[1]))
        self.check(pools=True)

    def check(self, pools=False):
        j, t = self.j, self.t
        np.testing.assert_array_equal(j.page_table, t.page_table)
        np.testing.assert_array_equal(j.seq_lens, t.seq_lens)
        np.testing.assert_array_equal(j._ref, t._ref)
        assert j._free == t._free
        assert list(j._cached) == list(t._cached)
        assert j._owned == t._owned and j._exclusive == t._exclusive
        assert sorted(j._page_entry) == sorted(t._page_entry)
        assert j.stats() == t.stats()
        if pools:
            np.testing.assert_array_equal(np.asarray(j.k_pool),
                                          t.k_pool.numpy())
            np.testing.assert_array_equal(np.asarray(j.v_pool),
                                          t.v_pool.numpy())


def test_scripted_prefix_sharing_cow_and_writes_match():
    rng = np.random.RandomState(0)
    p = _Pair(num_pages=12, rng=rng)
    donor = np.arange(1, 13, dtype=np.int32)          # 1 full + partial 4
    assert p.admit(0, donor, 20) == (0, None, None)
    p.write(0, 0, 12, layer=0)
    p.write(0, 0, 12, layer=1)
    p.both("insert_prefix", 0, donor)
    probe = np.concatenate([donor[:10], [99, 98]]).astype(np.int32)
    matched, src, dst = p.admit(1, probe, 24)         # diverges in page 2
    assert matched == 10 and src is not None and dst is not None
    p.write(1, 10, 6, layer=0)                        # lands in the CoW page
    p.both("free", 0)
    p.both("shed_cached", 1)
    p.both("reserve", 2, 40)                          # pool pressure
    p.both("free", 1)
    p.both("reserve", 2, 64)                          # reclaims cached
    p.both("free", 2)
    p.both("clear_prefix_index")
    p.both("reset_pools")
    p.check(pools=True)


def test_random_churn_matches():
    # seeded mixed churn: admissions with and without shared prefixes,
    # frees, sheds and writes, including OutOfPages refusals — the two
    # allocators must take the same decision at every step
    rng = np.random.RandomState(1)
    p = _Pair(num_pages=16, rng=rng)
    system = rng.randint(1, 50, 16).astype(np.int32)  # a 2-page prefix
    live = {}
    hits = 0
    for _ in range(150):
        op = rng.choice(4, p=[0.45, 0.3, 0.1, 0.15])
        slot = int(rng.randint(_KW["num_slots"]))
        if op == 0 and slot not in live:
            tail = rng.randint(1, 50, int(rng.randint(1, 12)))
            prompt = (np.concatenate([system, tail]) if rng.rand() < 0.6
                      else tail).astype(np.int32)
            total = int(prompt.size + rng.randint(1, 16))
            if not p.j.can_admit_prefix(total, p.j.match_prefix(prompt)):
                assert not p.t.can_admit_prefix(total,
                                                p.t.match_prefix(prompt))
                continue
            matched, _src, _dst = p.admit(slot, prompt, total)
            hits += matched > 0
            n = int(prompt.size) - matched
            if n:
                p.write(slot, matched, n, layer=int(rng.randint(2)))
            p.both("insert_prefix", slot, prompt)
            live[slot] = prompt
        elif op == 1 and slot in live:
            p.both("free", slot)
            del live[slot]
        elif op == 2:
            p.both("shed_cached", int(rng.randint(1, 3)))
        elif op == 3 and slot in live:
            # grow a live slot, sometimes past what the pool can give
            p.both("reserve", slot, int(rng.randint(1, 65)))
    for slot in list(live):
        p.both("free", slot)
    p.check(pools=True)
    assert p.t.pages_in_use == 0
    assert hits >= 5 and p.t.prefix_misses >= 5  # both paths exercised


def test_port_cache_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(MXNetError, match="no CUDA device"):
        tkv.PagedKVCache(2, 16, 1, 1, 4, page_size=8, name="nodev")
