"""Rank-side cases of the port's multi-process CPU tests.

Run by the port's launcher, one process a rank:

    python mxnet_tpu_torch/tools/launch.py -n N -- \\
        python tests/torch_dist_ranks.py OUT_DIR CASE [CASE ...]

Each rank joins the job (``kvstore.init_distributed``, gloo on the CPU),
runs the named cases on inputs made from fixed seeds with numpy, the same
on every rank, and writes what it got to ``OUT_DIR/rank<r>.npz``; the
test process holds those arrays against the JAX package on the same
inputs. This file imports numpy, torch and the port only (the ranks must
not import JAX), and the test files import its input makers.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

SHAPE = (3, 5)
OPS = ("sum", "mean", "max", "min")
MULTI_SHAPES = ((4,), (2, 3), (5, 1))


# -- inputs (shared with the test process) ---------------------------------

def per_rank_floats(n, seed=1):
    rs = np.random.RandomState(seed)
    return [rs.randn(*SHAPE).astype(np.float32) for _ in range(n)]


def per_rank_ints(n, seed=2):
    rs = np.random.RandomState(seed)
    return [rs.randint(-50, 50, SHAPE).astype(np.int32) for _ in range(n)]


def prereduce_copies(n, seed=3):
    """Rank r holds r + 2 integer-valued float copies (counts differ)."""
    rs = np.random.RandomState(seed)
    return [[rs.randint(-9, 9, SHAPE).astype(np.float32)
             for _ in range(r + 2)] for r in range(n)]


def multi_groups(n, copies, seed=4):
    """``[rank][group][copy]`` integer-valued float arrays."""
    rs = np.random.RandomState(seed)
    return [[[rs.randint(-9, 9, s).astype(np.float32) for _ in range(copies)]
             for s in MULTI_SHAPES] for _ in range(n)]


def kv_copies(n, seed=5):
    """``[rank][key][copy]``: 6 small keys, 2 copies a rank."""
    rs = np.random.RandomState(seed)
    shapes = [(4,), (3, 2), (7,), (2, 2), (5,), (1,)]
    return [[[rs.randint(-9, 9, s).astype(np.float32) for _ in range(2)]
             for s in shapes] for _ in range(n)]


def qkv(b=2, h=4, s=16, d=8, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, s, d).astype(np.float32) * 0.5 for _ in range(3)]


TRAINER_SEED = 13


def trainer_data(seed=TRAINER_SEED):
    xs = np.random.RandomState(seed).rand(16, 6).astype(np.float32)
    ys = np.random.RandomState(seed + 1).rand(16, 1).astype(np.float32)
    return xs, ys


# -- cases -----------------------------------------------------------------

def case_collectives(out, rank, n, cpu):
    import torch

    from mxnet_tpu_torch import parallel

    def t(a):
        return torch.from_numpy(np.array(a))

    for op in OPS:
        out["dev_f_" + op] = parallel.all_reduce(
            [t(per_rank_floats(n)[rank])], op).numpy()
        out["dev_i_" + op] = parallel.all_reduce(
            [t(per_rank_ints(n)[rank])], op).numpy()
        out["pre_" + op] = parallel.all_reduce(
            [t(c) for c in prereduce_copies(n)[rank]], op).numpy()
        ints = [t(c.astype(np.int32)) for c in prereduce_copies(n)[rank]]
        out["pre_i_" + op] = parallel.all_reduce(ints, op).numpy()
    for copies in (1, 2):
        groups = multi_groups(n, copies)[rank]
        res = parallel.all_reduce_multi([[t(c) for c in g] for g in groups])
        for j, r in enumerate(res):
            out["multi%d_%d" % (copies, j)] = r.numpy()


def sharding_batch(seed=6):
    """An (8, 3) batch and a (5, 2) one the ranks cannot split evenly."""
    rs = np.random.RandomState(seed)
    return (rs.randn(8, 3).astype(np.float32),
            rs.randn(5, 2).astype(np.float32))


def case_shardings(out, rank, n, cpu):
    import torch

    from mxnet_tpu_torch import parallel

    mesh = parallel.device_mesh(devices=[cpu])
    even, ragged = (torch.from_numpy(a) for a in sharding_batch())
    sh = parallel.batch_sharding(mesh, 2)
    out["sh_spec"] = np.asarray([str(x) for x in sh.spec])
    block = parallel.shard_to_mesh(even, mesh)
    out["sh_even"] = block.numpy()
    # laid out already: the put is skipped, the same tensor comes back
    assert parallel.put_sharded(block, sh) is block
    assert parallel.put_sharded(block, parallel.resolve_sharding(
        lambda nd: parallel.batch_sharding(mesh, nd), 2)) is block
    out["sh_ragged"] = parallel.shard_to_mesh(ragged, mesh).numpy()
    fresh = parallel.fresh_replicate(even, mesh)
    assert fresh.data_ptr() != even.data_ptr()
    out["sh_fresh"] = fresh.numpy()
    fresh_b = parallel.fresh_replicate(block, mesh, target=sh)
    assert fresh_b.data_ptr() != block.data_ptr()
    out["sh_fresh_block"] = fresh_b.numpy()
    copies = parallel.broadcast_to_devices(even, [cpu, cpu])
    assert all(c.data_ptr() != even.data_ptr() for c in copies)
    out["sh_bcast"] = np.stack([c.numpy() for c in copies])
    out["sh_for_device"] = parallel.shard_for_device(even, cpu).numpy()


def case_heartbeat(out, rank, n, cpu):
    from mxnet_tpu_torch import _dist, elastic

    grp = _dist.group()
    elastic.stop_heartbeat()
    assert elastic.start_heartbeat(0.1)
    time.sleep(0.3)
    out["hb_alive"] = np.asarray(elastic.get_dead_nodes(timeout=5.0),
                                 np.int64).reshape(-1)
    grp.barrier()
    if rank == n - 1:
        elastic.stop_heartbeat()
    grp.barrier()
    # the stopped rank's last beat is 2 s old, the others' 0.1 s (a busy
    # test machine may hold a beat back, but not by 1.5 s)
    time.sleep(2.0)
    out["hb_dead"] = np.asarray(elastic.get_dead_nodes(timeout=1.5),
                                np.int64).reshape(-1)
    grp.barrier()


def case_kvstore(out, rank, n, cpu):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd

    with cpu:
        kv = mx.kv.create("dist_sync")
        out["kv_rank"] = np.asarray([kv.rank, kv.num_workers])
        mine = kv_copies(n)[rank]
        keys = list(range(len(mine)))
        for k, g in zip(keys, mine):
            kv.init(k, nd.zeros(g[0].shape))
        # push + pull, key by key
        kv.push(keys[0], [nd.array(c) for c in mine[0]])
        o = nd.zeros(mine[0][0].shape)
        kv.pull(keys[0], out=o)
        out["kv_push_0"] = o.asnumpy()
        # the batched exchange, bucketed and not
        for cap in ("4", "0"):
            os.environ["MXNET_KVSTORE_BUCKET_MB"] = cap
            outs = [[nd.zeros(g[0].shape) for _ in g] for g in mine]
            kv.pushpull_multi(keys, [[nd.array(c) for c in g] for g in mine],
                              outs)
            for k, o in zip(keys, outs):
                out["kv_ppm%s_%d" % (cap, k)] = o[0].asnumpy()
                assert all(np.array_equal(x.asnumpy(), o[0].asnumpy())
                           for x in o)
        os.environ.pop("MXNET_KVSTORE_BUCKET_MB")
        kv._barrier()


def case_trainer(out, rank, n, cpu, params_file=None):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.gluon import nn

    xs, ys = trainer_data()
    rows = slice(rank * 16 // n, (rank + 1) * 16 // n)
    init = dict(np.load(params_file))
    for update_on_kvstore in (False, True):
        with cpu:
            net = nn.HybridSequential(prefix="tt_")
            with net.name_scope():
                net.add(nn.Dense(8, activation="relu"))
                net.add(nn.Dense(1))
            net.initialize()
            with mx.autograd.pause():
                net(nd.array(xs[rows]))
            gluon.params_from_jax(net, init)
            trainer = gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.05}, kvstore="tpu",
                                    update_on_kvstore=update_on_kvstore)
            loss_fn = gluon.loss.L2Loss()
            for _ in range(3):
                with mx.autograd.record():
                    loss = loss_fn(net(nd.array(xs[rows])),
                                   nd.array(ys[rows]))
                loss.backward()
                trainer.step(16)
        for name, p in net.collect_params().items():
            out["tr%d_%s" % (int(update_on_kvstore), name)] = \
                p.data().asnumpy()


def case_sequence(out, rank, n, cpu):
    import torch

    from mxnet_tpu_torch import parallel, sequence_parallel as sp

    mesh = sp.sequence_mesh(devices=[cpu])
    q0, k0, v0 = qkv(h=4 if n <= 4 else n)
    for name, fn in (("ring", sp.ring_attention),
                     ("uly", sp.ulysses_attention)):
        for causal in (False, True):
            q, k, v = (torch.tensor(a, requires_grad=True)
                       for a in (q0, k0, v0))
            o = fn(q, k, v, mesh=mesh, causal=causal)
            (o ** 2).sum().backward()
            key = "%s_%d" % (name, int(causal))
            out[key] = o.detach().numpy()
            # each rank's loss is its block's: the job's gradient is the
            # sum over ranks
            for g, x in zip("qkv", (q, k, v)):
                out[key + "_d" + g] = parallel.all_reduce(
                    [x.grad], "sum").numpy()


def case_ring_prefill(out, rank, n, cpu):
    import torch

    from mxnet_tpu_torch import parallel, serving
    from mxnet_tpu_torch.serving.decode import ring_prefill_attention

    model = serving.TinyDecoder(vocab_size=32, num_layers=2, num_heads=4,
                                head_dim=8, num_kv_heads=2)
    rs = np.random.RandomState(9)
    t = 8 * n
    q = torch.tensor(rs.randn(t, 4, 8).astype(np.float32))
    k, v = (torch.tensor(rs.randn(t, 2, 8).astype(np.float32))
            for _ in range(2))
    mesh = parallel.device_mesh(axis_names=("sp",), devices=[cpu])
    out["rp_ring"] = ring_prefill_attention(mesh, model)(
        q, k, v, model.scale).numpy()
    out["rp_dense"] = model._dense_causal(q, k, v, model.scale).numpy()


# -- ZeRO (fastpath.zero) --------------------------------------------------

ZERO_B = 8  # a power of two: 1 / (2 * B) loss scaling is exact
ZERO_STEPS = 5
ZERO_SHAPES = ((16, 6), (16,), (8, 16), (8,))
ZERO_OPTS = (("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
             ("adam", {"learning_rate": 0.01}))
ZERO_MP_OPTS = (("sgd", {"momentum": 0.9, "multi_precision": True}),
                ("adam", {"multi_precision": True}))
ZERO_INELIGIBLE = (("nadam", {}, "order-sensitive host prologue (Nadam)"),
                   ("sgld", {}, "order-sensitive host prologue (SGLD)"),
                   ("lbsgd", {"momentum": 0.9},
                    "non-pointwise _leaf_step (LBSGD)"))


def zero_data(seed=3):
    """``tests/test_zero.py``'s batches: 5 of B rows of 6 features."""
    rs = np.random.RandomState(seed)
    return (rs.rand(ZERO_STEPS * ZERO_B, 6).astype(np.float32),
            rs.randint(0, 8, (ZERO_STEPS * ZERO_B,)))


def zero_tensors(seed):
    """``tests/test_zero.py``'s weights and gradients over ZERO_SHAPES."""
    rs = np.random.RandomState(seed)
    return ([rs.rand(*s).astype(np.float32) for s in ZERO_SHAPES],
            [rs.rand(*s).astype(np.float32) for s in ZERO_SHAPES])


def _zero_counts():
    from mxnet_tpu_torch.fastpath import zero

    return (sum(s["value"] for s in zero.FALLBACKS.series()),
            zero.MATERIALIZATIONS.value())


def _state_arrays(out, key, states):
    from mxnet_tpu_torch.optimizer import _state_leaves

    for i in sorted(states):
        for j, t in enumerate(_state_leaves(states[i])):
            out["%s_s%d_%d" % (key, i, j)] = t.detach().float().numpy().copy()


def _zero_mlp(prefix, init, xs):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu"))
        net.add(nn.Dense(8))
    net.initialize()
    with mx.autograd.pause():
        net(nd.array(xs[:ZERO_B]))
    # by position: the JAX net's prefix differs
    params = list(net.collect_params().values())
    assert len(params) == len(init)
    for p, v in zip(params, init.values()):
        p.set_data(nd.array(v))
    net.hybridize()
    return net


def case_zero_mlp(out, rank, n, cpu, init_file):
    """The MLP of ``tests/test_zero.py`` through a dist_sync Trainer at
    MXNET_ZERO 0, 1 and 2: every rank trains on the whole batch and steps
    with 2 B, so the reduced gradient is one process's; the weights, the
    materialized states and the plane's readings a run."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.fastpath import zero

    init = dict(np.load(init_file))
    xs, ys = zero_data()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for opt, params in ZERO_OPTS:
        for lv in (0, 1, 2):
            key = "zm_%s%d" % (opt, lv)
            os.environ["MXNET_ZERO"] = str(lv)
            with cpu:
                net = _zero_mlp("zm%s%d_" % (opt, lv), init, xs)
                tr = gluon.Trainer(net.collect_params(), opt, dict(params),
                                   kvstore="dist_sync")
                f0, m0 = _zero_counts()
                for s in range(ZERO_STEPS):
                    rows = slice(s * ZERO_B, (s + 1) * ZERO_B)
                    with mx.autograd.record():
                        loss = loss_fn(net(nd.array(xs[rows])),
                                       nd.array(ys[rows]))
                    loss.backward()
                    tr.step(2 * ZERO_B)
            upd = tr._updater
            plane = zero.plane_of(upd)
            out[key + "_bytes"] = np.asarray(
                [zero.state_bytes_on("cpu", upd)])
            if lv:
                assert plane is not None and plane.dp == n
                assert plane.level == lv
                assert all(zero.is_sharded(st) for st in upd.states.values())
                zero.materialize_updater(upd)
            else:
                assert plane is None
            f1, m1 = _zero_counts()
            out[key + "_counts"] = np.asarray([f1 - f0, m1 - m0])
            for i, p in enumerate(tr._params):
                out["%s_w%d" % (key, i)] = p.data().asnumpy()
            _state_arrays(out, key, upd.states)
    os.environ.pop("MXNET_ZERO")


def case_zero_bf16(out, rank, n, cpu):
    """``tests/test_zero.py``'s bf16 weights with float32 masters through
    ``fastpath.apply_updater`` at MXNET_ZERO 0, 1 and 2 (the same
    gradients on every rank: the reduced ones), 5 steps; the master
    slot's length a rank, the weights and the materialized states."""
    import torch

    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.fastpath import fused, zero

    ws, gs = zero_tensors(1)
    for opt, kwargs in ZERO_MP_OPTS:
        for lv in (0, 1, 2):
            key = "zb_%s%d" % (opt, lv)
            os.environ["MXNET_ZERO"] = str(lv)
            u = opt_mod.get_updater(opt_mod.create(opt, **kwargs))
            wl = [torch.tensor(w).to(torch.bfloat16) for w in ws]
            gl = [torch.tensor(g).to(torch.bfloat16) for g in gs]
            for _ in range(ZERO_STEPS):
                fused.apply_updater(u, list(zip(range(len(ws)), gl, wl)))
            plane = zero.plane_of(u)
            if lv:
                out[key + "_master_len"] = np.asarray(
                    [plane.buckets[0][0].numel(),
                     plane.plan.bucket_layout(0)[1]])
                zero.materialize_updater(u)
            for i, w in enumerate(wl):
                out["%s_w%d" % (key, i)] = w.float().numpy()
            _state_arrays(out, key, u.states)
    os.environ.pop("MXNET_ZERO")


def case_zero_misc(out, rank, n, cpu):
    """The fallbacks (ineligible optimizers, update_on_kvstore,
    MXNET_ZERO_DEVICES=1), the knob turned off mid-run, an eager
    per-parameter update between sharded steps, and the state bytes a
    rank."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.fastpath import fused, zero

    ws, gs = zero_tensors(0)

    def triples():
        return list(zip(range(len(ws)), [torch.tensor(g) for g in gs],
                        [torch.tensor(w) for w in ws]))

    os.environ["MXNET_ZERO"] = "1"
    for i, (opt, kwargs, reason) in enumerate(ZERO_INELIGIBLE):
        before = zero.FALLBACKS.value(reason=reason)
        u = opt_mod.get_updater(opt_mod.create(opt, **kwargs))
        fused.apply_updater(u, triples())
        out["zx_inel%d" % i] = np.asarray([
            zero.FALLBACKS.value(reason=reason) - before,
            zero.plane_of(u) is None,
            not any(zero.is_sharded(st) for st in u.states.values())])
    kv = mx.kv.create("local")
    kv.set_optimizer(opt_mod.create("sgd", momentum=0.9))
    before = zero.FALLBACKS.value(reason="update_on_kvstore")
    fused.apply_updater(kv._updater, triples())
    out["zx_optout"] = np.asarray([
        kv._updater._zero_opt_out == "update_on_kvstore",
        zero.FALLBACKS.value(reason="update_on_kvstore") - before,
        zero.plane_of(kv._updater) is None])
    os.environ["MXNET_ZERO_DEVICES"] = "1"
    reason = "1-device mesh (sharding is a no-op)"
    before = zero.FALLBACKS.value(reason=reason)
    u = opt_mod.get_updater(opt_mod.create("sgd", momentum=0.9))
    fused.apply_updater(u, triples())
    out["zx_devices1"] = np.asarray([
        zero.FALLBACKS.value(reason=reason) - before,
        zero.plane_of(u) is None])
    os.environ["MXNET_ZERO_DEVICES"] = str(n)

    # the knob turned off mid-run: 3 sharded + 2 replicated steps against
    # 5 replicated ones
    _ws, gs2 = zero_tensors(2)
    for tag, levels in (("r", "00000"), ("z", "11100")):
        u = opt_mod.get_updater(opt_mod.create("adam"))
        wl = [torch.tensor(w) for w in _ws]
        planes = []
        for lv in levels:
            os.environ["MXNET_ZERO"] = lv
            fused.apply_updater(u, list(zip(range(len(wl)),
                                            [torch.tensor(g) for g in gs2],
                                            wl)))
            planes.append(zero.plane_of(u) is not None)
        out["zx_flip_%s_planes" % tag] = np.asarray(planes)
        for i, w in enumerate(wl):
            out["zx_flip_%s_w%d" % (tag, i)] = w.numpy().copy()
        _state_arrays(out, "zx_flip_" + tag, u.states)

    # an eager per-parameter update between sharded steps
    os.environ["MXNET_ZERO"] = "1"
    u = opt_mod.get_updater(opt_mod.create("sgd", momentum=0.9))
    tr = triples()
    fused.apply_updater(u, tr)
    first = zero.is_sharded(u.states[0])
    u(0, tr[0][1], tr[0][2])
    detached = zero.plane_of(u) is None and not any(
        zero.is_sharded(st) for st in u.states.values())
    fused.apply_updater(u, tr)
    out["zx_interleave"] = np.asarray([first, detached,
                                       zero.plane_of(u) is not None])

    # the state bytes a rank: sharded, then materialized
    u = opt_mod.get_updater(opt_mod.create("adam"))
    fused.apply_updater(u, triples())
    sharded = zero.state_bytes_on("cpu", u)
    zero.materialize_updater(u)
    out["zx_bytes"] = np.asarray([sharded, zero.state_bytes_on("cpu", u)])
    os.environ.pop("MXNET_ZERO")
    os.environ.pop("MXNET_ZERO_DEVICES")


def case_zero_solo(out, rank, n, cpu):
    """A materialization that rank 0 calls alone: it must raise within
    its bound (the job's collective timeout, cut to 2 s here), not hang.
    The job's last collective case: rank 0's barrier numbering runs ahead
    after it."""
    import torch

    from mxnet_tpu_torch import _dist, optimizer as opt_mod
    from mxnet_tpu_torch.fastpath import fused, zero

    ws, gs = zero_tensors(0)
    os.environ["MXNET_ZERO"] = "1"
    u = opt_mod.get_updater(opt_mod.create("sgd", momentum=0.9))
    fused.apply_updater(u, list(zip(range(len(ws)),
                                    [torch.tensor(g) for g in gs],
                                    [torch.tensor(w) for w in ws])))
    os.environ.pop("MXNET_ZERO")
    if rank != 0:
        return
    bound = _dist._TIMEOUT_S
    _dist._TIMEOUT_S = 2.0
    t0 = time.perf_counter()
    try:
        zero.materialize_updater(u)
        raised = ""
    except zero.ZeroCollectiveError as exc:
        raised = str(exc)
    out["zs_seconds"] = np.asarray([time.perf_counter() - t0])
    out["zs_raised"] = np.asarray([raised])
    out["zs_attached"] = np.asarray([zero.plane_of(u) is not None])
    _dist._TIMEOUT_S = bound


# -- elastic: sharded checkpoints and resume --------------------------------

EL_B, EL_STEPS, EL_EVERY = 8, 6, 2
EL_OPT = ("adam", {"learning_rate": 0.01})


def elastic_data(seed=3):
    rs = np.random.RandomState(seed)
    return (rs.rand(EL_STEPS * EL_B, 6).astype(np.float32),
            rs.randint(0, 8, (EL_STEPS * EL_B,)).astype(np.float32))


def elastic_model(prefix, opt=EL_OPT, kvstore="dist_sync", cast=None):
    """``tests/test_elastic_resume.py``'s MLP and Trainer, seeded (the
    current context's)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.gluon import nn

    mx.random.seed(7)
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu"), nn.Dense(8))
    net.initialize()
    with mx.autograd.pause():
        net(nd.ones((EL_B, 6)))
    if cast:
        net.cast(cast)
    net.hybridize()
    return net, gluon.Trainer(net.collect_params(), opt[0], dict(opt[1]),
                              kvstore=kvstore)


def elastic_step(net, trainer, xs, ys, s, n, cast=None):
    """Step ``s`` of the job: every rank the same batch, ``step(n B)``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd

    x = nd.array(xs[s * EL_B:(s + 1) * EL_B])
    if cast:
        x = x.astype(cast)
    with mx.autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            net(x), nd.array(ys[s * EL_B:(s + 1) * EL_B]))
    loss.backward()
    trainer.step(n * EL_B)


def materialized(trainer):
    """The trainer's states in the plain layout (a collective under a
    plane), as float32 numpy by (index, leaf)."""
    from mxnet_tpu_torch.fastpath import zero
    from mxnet_tpu_torch.optimizer import _state_leaves

    upd = trainer._updater
    zero.materialize_updater(upd)
    return {(i, j): t.detach().float().numpy().copy()
            for i in sorted(upd.states)
            for j, t in enumerate(_state_leaves(upd.states[i]))}


def _put(out, key, arrays):
    for (i, j), a in arrays.items():
        out["%s_%d_%d" % (key, i, j)] = a


def case_elastic_zero(out, rank, n, cpu, base):
    """Sharded saves at MXNET_ZERO=1: the save's materializations and
    files, the 2-rank restore, the replicated level-1 masters, torn-write
    and drop-shard fallbacks, kill-at-step resume through the eager
    Trainer and an agreed preemption; arrays for the test to compare."""
    import json

    from mxnet_tpu_torch import elastic, telemetry
    from mxnet_tpu_torch.fastpath import zero
    from mxnet_tpu_torch.resilience import chaos

    xs, ys = elastic_data()
    os.environ["MXNET_ZERO"] = "1"
    with cpu:
        # the sharded save: no all-gather, one shard file a rank
        d = os.path.join(base, "sharded")
        net, tr = elastic_model("es_")
        for s in range(3):
            elastic_step(net, tr, xs, ys, s, n)
        cm = elastic.CheckpointManager(d)
        m0 = zero.MATERIALIZATIONS.value()
        t0 = telemetry.TRANSFER_BYTES.value(path="ckpt.shard")
        cm.save_training(0, net=net, trainer=tr)
        manifest = json.load(open(cm._manifest_path(0)))
        out["es_save"] = np.asarray([
            zero.MATERIALIZATIONS.value() - m0,
            telemetry.TRANSFER_BYTES.value(path="ckpt.shard") > t0,
            all(zero.is_sharded(st) for st in tr._updater.states.values()),
            len(manifest["shards"]),
            manifest["sharded"] == {"dp": n, "level": 1,
                                    "mesh_shape": {"dp": n}}])
        out["es_files"] = np.asarray(sorted(os.listdir(d)))
        _put(out, "es_want", materialized(tr))
        out["es_counts"] = np.asarray([tr._optimizer.num_update] + [
            tr._optimizer._index_update_count[i] for i in range(4)])
        # the restore onto this job's ranks
        net2, tr2 = elastic_model("er_")
        assert cm.restore_training(net=net2, trainer=tr2) == 0
        _put(out, "es_got2", materialized(tr2))
        out["es_counts2"] = np.asarray([tr2._optimizer.num_update] + [
            tr2._optimizer._index_update_count[i] for i in range(4)])
        out["es_params_equal"] = np.asarray([
            np.array_equal(a.data().asnumpy(), b.data().asnumpy())
            for a, b in zip(net.collect_params().values(),
                            net2.collect_params().values())])

        # level 1 with bf16 weights: the float32 masters replicated, saved
        # once in the .repl file
        d = os.path.join(base, "masters")
        mp = ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                      "multi_precision": True})
        net, tr = elastic_model("em_", opt=mp, cast="bfloat16")
        for s in range(2):
            elastic_step(net, tr, xs, ys, s, n, cast="bfloat16")
        cm = elastic.CheckpointManager(d)
        cm.save_training(0, net=net, trainer=tr)
        out["em_repl"] = np.asarray([any(f.endswith(".repl")
                                         for f in os.listdir(d))])
        want = materialized(tr)
        net2, tr2 = elastic_model("en_", opt=mp, cast="bfloat16")
        assert cm.restore_training(net=net2, trainer=tr2) == 0
        got = materialized(tr2)
        out["em_equal"] = np.asarray([sorted(want) == sorted(got)] + [
            np.array_equal(want[k], got[k]) for k in want])

        # torn-write and drop-shard against the newest epoch
        for tag, action in (("torn", "torn-write"), ("drop", "drop-shard")):
            d = os.path.join(base, tag)
            net, tr = elastic_model("ec%s_" % tag)
            cm = elastic.CheckpointManager(d)
            elastic_step(net, tr, xs, ys, 0, n)
            elastic_step(net, tr, xs, ys, 1, n)
            cm.save_training(0, net=net, trainer=tr)
            want = materialized(tr)
            elastic_step(net, tr, xs, ys, 2, n)
            with chaos.active("site=ckpt.shard,at=1,action=%s" % action):
                cm.save_training(1, net=net, trainer=tr)
            latest = cm.latest_epoch()
            c0 = telemetry.CKPT_CORRUPTION.value()
            net2, tr2 = elastic_model("ed%s_" % tag)
            epoch = cm.restore_training(net=net2, trainer=tr2)
            got = materialized(tr2)
            out["ec_%s" % tag] = np.asarray([
                latest, epoch, telemetry.CKPT_CORRUPTION.value() - c0,
                all(np.array_equal(want[k], got[k]) for k in want)])

        # kill-at-step resume through the eager Trainer, and a preemption
        # that reaches rank 0 only, against an uninterrupted run
        runs = {}
        for tag in ("ref", "kill", "preempt"):
            runs[tag] = _elastic_run(os.path.join(base, "run_" + tag), tag,
                                     rank, n, xs, ys)
        for tag, got in runs.items():
            for k, v in got.items():
                out["er_%s_%s" % (tag, k)] = v
    os.environ.pop("MXNET_ZERO")


def _elastic_run(d, tag, rank, n, xs, ys):
    """EL_STEPS steps through ``run_elastic`` with an async sharded save
    every EL_EVERY steps; ``kill``: chaos kill entering step 3 (both
    ranks); ``preempt``: a preemption file that only rank 0 watches,
    written after step 1, then a resumed attempt to the end."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import elastic, telemetry
    from mxnet_tpu_torch.resilience import chaos

    cm = elastic.CheckpointManager(d)
    final = {}
    flag = os.path.join(d, "evict-notice")
    if tag == "preempt" and rank == 0:
        os.environ["MXNET_PREEMPTION_FILE"] = flag

    def train_fn(start_epoch, manager):
        net, tr = elastic_model("e%s%d_" % (tag, start_epoch))
        it = mx.io.NDArrayIter(xs, ys, batch_size=EL_B)
        last = manager.restore_training(net=net, trainer=tr, train_iter=it)
        for step in range(last + 1, EL_STEPS):
            elastic.step_boundary(
                manager=manager,
                save_fn=lambda s=step: manager.save_training(
                    s - 1, net=net, trainer=tr, train_iter=it))
            batch = it.next()
            with mx.autograd.record():
                loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                    net(batch.data[0]), batch.label[0])
            loss.backward()
            tr.step(n * EL_B)
            if tag == "preempt" and rank == 0 and step == 1:
                open(flag, "w").close()
            if (step + 1) % EL_EVERY == 0:
                manager.save_training(step, net=net, trainer=tr,
                                      train_iter=it, async_save=True)
        manager.wait()
        final.update(net=net, tr=tr, it=it)
        return "done"

    restarts = telemetry.ELASTIC_RESTARTS.value(reason="exception")
    preempted = []
    if tag == "kill":
        with chaos.active("site=elastic.step,at=4,action=kill"):
            elastic.run_elastic(train_fn, cm, max_restarts=3,
                                restart_delay=0)
    elif tag == "preempt":
        try:
            elastic.run_elastic(train_fn, cm, max_restarts=0,
                                restart_delay=0)
        except elastic.Preempted:
            preempted.append(cm.latest_epoch())
        os.environ.pop("MXNET_PREEMPTION_FILE", None)
        elastic.clear_preemption()
        if os.path.exists(flag):
            os.remove(flag)
        elastic.run_elastic(train_fn, cm, max_restarts=0, restart_delay=0)
    else:
        elastic.run_elastic(train_fn, cm, max_restarts=0, restart_delay=0)
    net, tr, it = final["net"], final["tr"], final["it"]
    got = {"restarts": np.asarray([telemetry.ELASTIC_RESTARTS.value(
        reason="exception") - restarts]),
        "preempted": np.asarray(preempted or [-1]),
        "cursor": np.asarray([it.cursor]),
        "counts": np.asarray([tr._optimizer.num_update] + [
            tr._optimizer._index_update_count[i] for i in range(4)])}
    for i, p in enumerate(net.collect_params().values()):
        got["w%d" % i] = p.data().asnumpy()
    for (i, j), a in materialized(tr).items():
        got["s%d_%d" % (i, j)] = a
    return got


def case_elastic_restore(out, rank, n, cpu, base):
    """The 2-rank sharded checkpoint of ``elastic_zero`` restored onto
    this job's ranks: the materialized states, then one step, which
    shards them over this job's ranks."""
    from mxnet_tpu_torch import elastic
    from mxnet_tpu_torch.fastpath import zero

    xs, ys = elastic_data()
    os.environ["MXNET_ZERO"] = "1"
    with cpu:
        cm = elastic.CheckpointManager(os.path.join(base, "sharded"))
        net, tr = elastic_model("eq_")
        assert cm.restore_training(net=net, trainer=tr) == 0
        _put(out, "eq_got", materialized(tr))
        elastic_step(net, tr, xs, ys, 3, n)
        out["eq_dp"] = np.asarray([zero.plane_of(tr._updater).dp])
    os.environ.pop("MXNET_ZERO")


# -- the captured planes across ranks (tests/test_torch_dist_planes.py) -----

PL_B, PL_K = 8, 3
PL_SGD = {"learning_rate": 0.1}
PL_MOM = {"learning_rate": 0.1, "momentum": 0.9}
MOD_B, MOD_N = 4, 16
# the sharded plane's optimizers (tests/test_zero.py:275-278)
PL_ZERO = (("sgd", PL_MOM), ("adam", {"learning_rate": 0.01}))
# pipeline_apply (tests/test_parallel.py:363): M microbatches of B rows
PP_M, PP_B, PP_D = 6, 2, 8


def planes_data(seed=21):
    """K global batches of PL_B images (2 x 6 x 6) with 3-class labels, a
    ragged batch of 5, BatchNorm's (PL_B, 3) batch, and the (T, N, C)
    sequences of the batch_axis=1 net with (T, N) labels."""
    rs = np.random.RandomState(seed)
    return dict(
        xs=rs.rand(PL_K, PL_B, 2, 6, 6).astype(np.float32),
        ys=rs.randint(0, 3, (PL_K, PL_B)).astype(np.float32),
        rx=rs.rand(5, 2, 6, 6).astype(np.float32),
        ry=rs.randint(0, 3, 5).astype(np.float32),
        bn=(rs.rand(PL_B, 3) * 5.0).astype(np.float32),
        tx=rs.rand(PL_K, 3, PL_B, 4).astype(np.float32),
        ty=rs.randint(0, 3, (PL_K, 3, PL_B)).astype(np.float32))


def pipeline_data(n, seed=0):
    """``n`` stages' (D, D) weights and the (M, B, D) microbatches of
    ``tests/test_parallel.py:370-373``."""
    rs = np.random.RandomState(seed)
    ws = rs.randn(n, PP_D, PP_D).astype(np.float32) * 0.3
    return ws, rs.randn(PP_M, PP_B, PP_D).astype(np.float32)


def module_data(rank, seed=30):
    """Rank ``rank``'s own MOD_N samples of 6 features, 3 classes."""
    rs = np.random.RandomState(seed + rank)
    return (rs.rand(MOD_N, 6).astype(np.float32),
            rs.randint(0, 3, MOD_N).astype(np.float32))


def plane_net(pkg, kind):
    """The nets of the planes' cases, built alike in both packages:
    ``conv`` (tests/test_parallel.py's conv, BatchNorm, relu, Dense), the
    lone ``bn`` BatchNorm, and ``axis1``, which reads (T, N, C) sequences
    (batch axis 1) through a BatchNorm over the channel axis."""
    nn = pkg.gluon.nn
    if kind == "bn":
        return nn.BatchNorm(prefix="plbn_")
    net = nn.HybridSequential(prefix="pl%s_" % kind)
    with net.name_scope():
        if kind == "conv":
            net.add(nn.Conv2D(4, kernel_size=3, padding=1))
            net.add(nn.BatchNorm())
            net.add(nn.Activation("relu"))
            net.add(nn.Flatten())
            net.add(nn.Dense(3))
        else:
            net.add(nn.Dense(4, flatten=False))
            net.add(nn.BatchNorm(axis=2))
            net.add(nn.Activation("relu"))
            net.add(nn.Dense(3, flatten=False))
    return net


def module_symbol(pkg):
    s = pkg.sym
    net = s.FullyConnected(s.var("data"), num_hidden=8, name="fc1")
    net = s.Activation(net, act_type="relu", name="relu1")
    net = s.FullyConnected(net, num_hidden=3, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _arrays(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


def case_planes(out, rank, n, cpu, init_file):
    """TrainStep, InferStep and TrainPlane over the job's ranks on the
    global batches of :func:`planes_data`, from the JAX package's initial
    weights; the module plane on each rank's own data; the eager
    dist_sync Trainer's per-rank BatchNorm statistics; the refusals; fit
    with a checkpoint, resumed."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import MXNetError, gluon, nd, parallel, telemetry
    from mxnet_tpu_torch import trainplane

    init = dict(np.load(init_file))
    d = planes_data()
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def fresh(kind, x):
        net = plane_net(mx, kind)
        net.initialize()
        with mx.autograd.pause():
            net(nd.array(x))
        gluon.params_from_jax(net, {k[len(kind) + 1:]: v for k, v in
                                    init.items() if k.startswith(kind + "/")})
        return net

    def put(key, arrays):
        for i, a in enumerate(arrays):
            out["%s_%d" % (key, i)] = np.asarray(a)

    with cpu:
        # TrainStep: 3 steps, the job's mean loss; then multi_call
        net = fresh("conv", d["xs"][0])
        step = parallel.TrainStep(net, ce, "sgd", optimizer_params=PL_SGD)
        out["ts_loss"] = np.asarray([step(nd.array(d["xs"][k]), nd.array(
            d["ys"][k])).asnumpy() for k in range(PL_K)])
        put("ts", [p.detach().numpy().copy() for p in step.params.values()])
        out["ts_counts"] = np.asarray([step.compile_count,
                                       step.collectives_a_step])
        out["ts_reason"] = np.asarray([str(step.uncaptured_reason)])
        net = fresh("conv", d["xs"][0])
        step = parallel.TrainStep(net, ce, "sgd", optimizer_params=PL_MOM)
        out["mc_loss"] = step.multi_call(nd.array(d["xs"]),
                                         nd.array(d["ys"])).asnumpy()
        put("mc", [p.detach().numpy().copy() for p in step.params.values()])
        # a ragged batch: replicated over the ranks
        net = fresh("conv", d["xs"][0])
        step = parallel.TrainStep(net, ce, "sgd", optimizer_params=PL_SGD)
        out["rg_loss"] = step(nd.array(d["rx"]), nd.array(d["ry"])).asnumpy()
        put("rg", [p.detach().numpy().copy() for p in step.params.values()])
        # BatchNorm's global statistics (tests/test_parallel.py:339)
        net = fresh("bn", d["bn"])
        step = parallel.TrainStep(net, lambda o, l: nd.sum(o * 0.0), "sgd",
                                  optimizer_params={"learning_rate": 0.0})
        step(nd.array(d["bn"]), nd.array(np.zeros(PL_B, np.float32)))
        put("bn", [p.detach().numpy().copy() for p in step.params.values()])
        # InferStep: the ranks' outputs gathered into the global batch's
        net = fresh("conv", d["xs"][0])
        infer = parallel.InferStep(net)
        out["inf"] = infer(nd.array(d["xs"][0])).asnumpy()
        out["inf_multi"] = infer.multi_call(nd.array(d["xs"])).asnumpy()
        out["inf_ragged"] = infer(nd.array(d["rx"])).asnumpy()
        # TrainPlane: the whole batch's per-sample losses, a ragged batch
        net = fresh("conv", d["xs"][0])
        tr = gluon.Trainer(net.collect_params(), "sgd", dict(PL_SGD))
        plane = trainplane.TrainPlane(net, ce, tr)
        g0 = telemetry.STEP_DISPATCHES.value(plane="graph")
        for k in range(2):
            out["tp_loss%d" % k] = plane.step(
                nd.array(d["xs"][k]), nd.array(d["ys"][k])).asnumpy()
        out["tp_loss_ragged"] = plane.step(nd.array(d["rx"]),
                                           nd.array(d["ry"])).asnumpy()
        put("tp", _arrays(net))
        # a block laid out by the plane's feed sharding counts its ranks'
        # rows: the step's default batch size is the global batch's
        block = parallel.put_sharded(nd.array(d["xs"][0])._data,
                                     plane.feed_sharding(4))
        out["tp_feed_rows"] = np.asarray([block.shape[0],
                                          parallel.global_rows(block, 0)])
        out["tp_state"] = np.asarray([
            plane.plane, str(plane.uncaptured_reason),
            str(plane.mesh.size)])
        out["tp_counts"] = np.asarray([
            plane.compile_count, plane.collectives_a_step,
            telemetry.STEP_DISPATCHES.value(plane="graph") - g0,
            parallel.UNCAPTURED_STEPS.value(site="trainplane.TrainPlane",
                                            reason="gloo")])
        # batch_axis=1: (T, N, C) sequences, the ranks split N
        ce1 = gluon.loss.SoftmaxCrossEntropyLoss(batch_axis=1)
        net = fresh("axis1", d["tx"][0])
        step = parallel.TrainStep(net, ce1, "sgd", optimizer_params=PL_SGD,
                                  batch_axis=1)
        out["ax_ts_loss"] = np.asarray([step(nd.array(d["tx"][k]), nd.array(
            d["ty"][k])).asnumpy() for k in range(2)])
        put("ax_ts", [p.detach().numpy().copy() for p in step.params.values()])
        net = fresh("axis1", d["tx"][0])
        out["ax_inf"] = parallel.InferStep(net, batch_axis=1)(
            nd.array(d["tx"][0])).asnumpy()
        tr = gluon.Trainer(net.collect_params(), "sgd", dict(PL_SGD))
        plane = trainplane.TrainPlane(net, ce1, tr, batch_axis=1)
        out["ax_tp_loss"] = plane.step(nd.array(d["tx"][0]),
                                       nd.array(d["ty"][0])).asnumpy()
        put("ax_tp", _arrays(net))
        # the eager dist_sync Trainer keeps each rank's own statistics
        net = fresh("bn", d["bn"])
        tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate":
                                                         0.1},
                           kvstore="dist_sync")
        rows = slice(rank * PL_B // n, (rank + 1) * PL_B // n)
        with mx.autograd.record():
            loss = nd.sum(net(nd.array(d["bn"][rows])))
        loss.backward()
        tr.step(PL_B)
        put("eager_bn", _arrays(net))
        # the module plane: each rank trains its own module, no collective
        xs, ys = module_data(rank)
        it = mx.io.NDArrayIter(xs, ys, MOD_B)
        mod = mx.module.Module(module_symbol(mx), context=cpu)
        g0 = telemetry.STEP_DISPATCHES.value(plane="graph")
        mod.fit(it, optimizer="sgd", optimizer_params=dict(PL_MOM),
                arg_params={k[4:]: nd.array(v) for k, v in init.items()
                            if k.startswith("mod/")}, num_epoch=2)
        out["mod_steps"] = np.asarray(
            [telemetry.STEP_DISPATCHES.value(plane="graph") - g0])
        args, _aux = mod.get_params()
        for k, v in args.items():
            out["mod_" + k] = v.asnumpy()
        # MXNET_ZERO across the ranks: the sharded step inside the plane
        # on tests/test_zero.py's MLP and batches (the global batch of
        # ZERO_B rows split over the ranks), at levels 1 and 2, its states
        # materialized afterwards, and the replicated plane (level 0)
        from mxnet_tpu_torch.fastpath import zero

        zxs, zys = zero_data()
        zinit = {i: init["zmlp/%d" % i] for i in range(len(ZERO_SHAPES))}
        for opt_name, params in PL_ZERO:
            for lv in (0, 1, 2):
                key = "zp_%s%d" % (opt_name, lv)
                net = _zero_mlp("zp%s%d_" % (opt_name, lv), zinit, zxs)
                tr = gluon.Trainer(net.collect_params(), opt_name,
                                   dict(params))
                plane = trainplane.TrainPlane(net, ce, tr)
                f0 = sum(s["value"] for s in zero.FALLBACKS.series())
                os.environ["MXNET_ZERO"] = str(lv)
                try:
                    out[key + "_loss"] = np.asarray([plane.step(
                        nd.array(zxs[k * ZERO_B:(k + 1) * ZERO_B]),
                        nd.array(zys[k * ZERO_B:(k + 1) * ZERO_B])).asnumpy()
                        for k in range(ZERO_STEPS)])
                finally:
                    os.environ.pop("MXNET_ZERO")
                put(key, _arrays(net))
                upd = tr._updater
                if not lv:
                    _state_arrays(out, key, upd.states)
                    continue
                zp = zero.plane_of(upd)
                halves = [slot.numel() * 2 == zp.plan.bucket_layout(b)[1]
                          for b, slots in enumerate(zp.buckets)
                          for j, slot in enumerate(slots)
                          if not zp.replicated_slot(b, j)]
                out[key + "_state"] = np.asarray([
                    all(zero.is_sharded(st) for st in upd.states.values()),
                    bool(halves) and all(halves),
                    plane.compile_count, plane.collectives_a_step,
                    sum(s["value"] for s in zero.FALLBACKS.series()) - f0,
                    len(zp.plan.buckets), zp.level])
                zero.materialize_updater(upd)
                _state_arrays(out, key, upd.states)
        # refusals: a mesh leaving ranks out (MXNET_ZERO across the ranks
        # no longer raises: "" below)
        net = fresh("conv", d["xs"][0])
        tr = gluon.Trainer(net.collect_params(), "sgd", dict(PL_SGD))
        os.environ["MXNET_ZERO"] = "1"
        try:
            trainplane.TrainPlane(net, ce, tr).step(nd.array(d["xs"][0]),
                                                    nd.array(d["ys"][0]))
            out["refuse_zero"] = np.asarray([""])
        except MXNetError as e:
            out["refuse_zero"] = np.asarray([str(e)])
        finally:
            os.environ.pop("MXNET_ZERO")
        try:
            trainplane.TrainPlane(net, ce, tr).step(nd.array(d["rx"]),
                                                    nd.array(d["ry"]))
            out["refuse_mesh"] = np.asarray([""])
        except MXNetError as e:
            out["refuse_mesh"] = np.asarray([str(e)])
        # no eager fallback in a job: a first pass that fails raises on
        # every rank (the loss fails once: an eager retry would pass), and
        # so does a configuration the plane cannot step
        calls = []

        def failing_once(o, l):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("planted first-pass failure")
            return ce(o, l)

        net = fresh("conv", d["xs"][0])
        tr = gluon.Trainer(net.collect_params(), "sgd", dict(PL_SGD))
        plane = trainplane.TrainPlane(net, failing_once, tr)
        try:
            plane.step(nd.array(d["xs"][0]), nd.array(d["ys"][0]))
            out["refuse_capture"] = np.asarray(["", str(plane.plane)])
        except RuntimeError as e:
            out["refuse_capture"] = np.asarray([str(e), str(plane.plane)])
        os.environ["MXNET_FASTPATH"] = "0"
        try:
            trainplane.TrainPlane(net, ce, tr).step(nd.array(d["xs"][0]),
                                                    nd.array(d["ys"][0]))
            out["refuse_eager"] = np.asarray([""])
        except MXNetError as e:
            out["refuse_eager"] = np.asarray([str(e)])
        finally:
            os.environ.pop("MXNET_FASTPATH")
        # fit across the ranks on the global batches with a checkpoint:
        # one epoch, then a fresh net resumed from it for the second
        from mxnet_tpu_torch import elastic

        ckpt = os.path.join(os.path.dirname(init_file), "fit_ckpt")
        xs, ys = d["xs"].reshape((-1,) + d["xs"].shape[2:]), \
            d["ys"].reshape(-1)
        for epochs in (1, 2):
            net = fresh("conv", d["xs"][0])
            tr = gluon.Trainer(net.collect_params(), "sgd", dict(PL_MOM))
            cm = elastic.CheckpointManager(ckpt)
            plane = trainplane.fit(net, ce, tr,
                                   mx.io.NDArrayIter(xs, ys, PL_B),
                                   epochs=epochs, checkpoint=cm)
        put("fit", _arrays(net))
        out["fit_state"] = np.asarray([cm.latest_epoch(), plane.step_count,
                                       plane.mesh.size])
        out["fit_plane"] = np.asarray([plane.plane])


def case_pipeline(out, rank, n, cpu):
    """``parallel.pipeline_apply`` over the job's ranks (a stage a rank):
    :func:`pipeline_data`'s ``tanh(x @ w)`` stages on all M microbatches
    and on the first alone; the staged bytes of the first call."""
    import torch

    from mxnet_tpu_torch import _dist, parallel

    ws, xs = pipeline_data(n)
    staged = _dist.group().staged_bytes

    def stage(w, x):
        return torch.tanh(x @ w)

    with cpu:
        mesh = parallel.device_mesh(axis_names=("pp",))
        out["pp"] = parallel.pipeline_apply(
            stage, torch.from_numpy(ws), torch.from_numpy(xs),
            mesh).numpy()
        out["pp_staged"] = np.asarray([_dist.group().staged_bytes - staged])
        out["pp_one"] = parallel.pipeline_apply(
            stage, torch.from_numpy(ws), torch.from_numpy(xs[:1]),
            mesh).numpy()
        try:
            parallel.pipeline_apply(stage, torch.from_numpy(ws[:1]),
                                    torch.from_numpy(xs), mesh)
            out["pp_refuse"] = np.asarray([""])
        except Exception as e:  # noqa: BLE001 - the message is the result
            out["pp_refuse"] = np.asarray([str(e)])


CASES = {"collectives": case_collectives, "heartbeat": case_heartbeat,
         "shardings": case_shardings,
         "kvstore": case_kvstore, "trainer": case_trainer,
         "sequence": case_sequence, "ring_prefill": case_ring_prefill,
         "zero_mlp": case_zero_mlp, "zero_bf16": case_zero_bf16,
         "zero_misc": case_zero_misc, "zero_solo": case_zero_solo,
         "elastic_zero": case_elastic_zero,
         "elastic_restore": case_elastic_restore, "planes": case_planes,
         "pipeline": case_pipeline}


def main(argv):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist, kvstore

    out_dir, names = argv[0], argv[1:]
    assert kvstore.init_distributed(), "launcher env missing"
    grp = _dist.group()
    out = {"world": np.asarray([grp.world]),
           "backend": np.asarray([grp.backend])}
    for name in names:
        case, _, arg = name.partition("=")
        if arg:
            CASES[case](out, grp.rank, grp.world, mx.cpu(), arg)
        else:
            CASES[case](out, grp.rank, grp.world, mx.cpu())
    np.savez(os.path.join(out_dir, "rank%d.npz" % grp.rank), **out)
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")
                   for m, v in sys.modules.items() if v is not None)
    print("rank %d: CASES_OK %s" % (grp.rank, " ".join(names)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
