"""The port's compiled DAGs (ray_tpu_torch.dag: bind, compile, the pinned
exec loop over shm rings, the star allreduce, the device transport on
torch) held to the JAX package's own tests and to its functions.

``tests/test_dag.py`` runs here unedited (``_torch_ported.py``), with
every ``ray_tpu`` name rewritten to ``ray_tpu_torch``. Left out:

- test_jax_array_staged_through_dag, test_tensor_ref_rides_dag_channels
  and test_stage_to_host_stages_jax_leaves_inside_pytrees build jax
  arrays; each is written anew below on torch tensors
  (test_torch_tensors_staged_through_dag,
  test_torch_tensor_ref_rides_dag_channels,
  test_stage_to_host_matches_jax_staging).

Every resolution of a group to the chunked ring or the ring-of-rings
compiles and reduces (test_ring_resolutions_raise_before_any_actor_is_pinned,
which raised until the ring was ported), held to the JAX package's
reduce of the same values.
"""

import collections

import numpy as np
import pytest
import torch

from _torch_ported import adopt, ported

SKIP = {
    "test_jax_array_staged_through_dag":
        "builds jax arrays: test_torch_tensors_staged_through_dag",
    "test_tensor_ref_rides_dag_channels":
        "builds jax arrays: test_torch_tensor_ref_rides_dag_channels",
    "test_stage_to_host_stages_jax_leaves_inside_pytrees":
        "builds jax arrays: test_stage_to_host_matches_jax_staging",
}

adopt(ported("test_dag"), globals(), skip=SKIP)

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch.dag import (InputNode, MultiOutputNode,  # noqa: E402
                               allreduce, compile)
from ray_tpu_torch.dag import runtime as truntime  # noqa: E402


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_torch_tensors_staged_through_dag(cluster):
    """A stage's tensors reach the next stage as CPU tensors of the same
    dtype and shape, inside a dict with a plain int; bf16 stays bf16,
    bit for bit."""

    @ray_tpu_torch.remote
    class P:
        def f(self, seed):
            import torch
            g = torch.Generator().manual_seed(seed)
            return {"x": torch.randn((64, 33), generator=g)
                    .to(torch.bfloat16),
                    "y": torch.arange(10, dtype=torch.int32) * seed,
                    "n": seed}

    @ray_tpu_torch.remote
    class C:
        def g(self, d):
            import torch
            assert isinstance(d["x"], torch.Tensor)
            return {"x": d["x"], "y": d["y"] + 1, "n": d["n"],
                    "dev": d["x"].device.type}

    p, c = P.remote(), C.remote()
    with InputNode() as inp:
        out = c.g.bind(p.f.bind(inp))
    cd = compile(out)
    try:
        for seed in (3, 4):
            v = cd.execute(seed).get(timeout=120)
            g = torch.Generator().manual_seed(seed)
            want = torch.randn((64, 33), generator=g).to(torch.bfloat16)
            assert v["dev"] == "cpu" and v["n"] == seed
            assert v["x"].dtype == torch.bfloat16
            assert torch.equal(_bits(v["x"]), _bits(want))
            assert torch.equal(v["y"], torch.arange(10, dtype=torch.int32)
                               * seed + 1)
    finally:
        cd.teardown()


def test_torch_tensor_ref_rides_dag_channels(cluster):
    """A stage that returns a TensorRef ships only the handle through
    the channel; the consumer stage resolves it (cross-process: one
    fetch) and frees it, so the producer's store ends empty."""

    @ray_tpu_torch.remote
    class Prod:
        def park(self, x):
            import torch

            from ray_tpu_torch.runtime.device_store import put_device
            return put_device(torch.as_tensor(x) * 3.0)

        def live(self):
            from ray_tpu_torch.runtime.device_store import _store
            return _store().live_count()

    @ray_tpu_torch.remote
    class Cons:
        def use(self, ref):
            from ray_tpu_torch.runtime.device_store import TensorRef
            assert isinstance(ref, TensorRef), type(ref)
            out = ref.resolve("cpu").numpy() + 1.0
            ref.free()
            return out

    p, c = Prod.remote(), Cons.remote()
    with InputNode() as inp:
        out = c.use.bind(p.park.bind(inp))
    cd = compile(out)
    try:
        x = np.arange(6.0, dtype=np.float32)
        v = cd.execute(x).get(timeout=120)
        assert np.allclose(v, x * 3.0 + 1.0)
        v2 = cd.execute(x + 1).get(timeout=120)
        assert np.allclose(v2, (x + 1) * 3.0 + 1.0)
    finally:
        cd.teardown()
    assert ray_tpu_torch.get(p.live.remote(), timeout=60) == 0


NT = collections.namedtuple("NT", ["loss", "grads"])


def test_stage_to_host_matches_jax_staging():
    """``_stage_to_host`` over the JAX test's pytree, with torch tensors
    where it has jax arrays: the same structure and values as the JAX
    package's staged numpy (bf16 compared as f32, keeping its dtype);
    numpy leaves and trees with no tensor pass through untouched. On
    the CPU a tensor is already on the host, so it stays itself (the
    card's staging runs in tests/test_torch_cuda.py)."""
    import jax.numpy as jnp

    from ray_tpu.dag.runtime import _stage_to_host as jstage
    rng = np.random.default_rng(0)
    a = rng.standard_normal(8).astype(np.float32)
    b = rng.standard_normal((3, 2)).astype(np.float32)
    z = np.zeros(4)
    jval = {"grads": [jnp.asarray(a), z],
            "meta": ("keep", jnp.asarray(b).astype(jnp.bfloat16)),
            "nt": NT(loss=jnp.asarray(a[:2]), grads={"w": z}),
            "loss": 1.5}
    tval = {"grads": [torch.from_numpy(a), z],
            "meta": ("keep", torch.from_numpy(b).to(torch.bfloat16)),
            "nt": NT(loss=torch.from_numpy(a[:2]), grads={"w": z}),
            "loss": 1.5}
    jout, tout = jstage(jval), truntime._stage_to_host(tval)
    assert np.array_equal(jout["grads"][0], tout["grads"][0].numpy())
    assert tout["meta"][1].dtype == torch.bfloat16
    assert np.array_equal(np.asarray(jout["meta"][1], np.float32),
                          tout["meta"][1].float().numpy())
    assert isinstance(tout["nt"], NT)
    assert np.array_equal(jout["nt"].loss, tout["nt"].loss.numpy())
    assert tout["grads"][1] is tval["grads"][1]
    assert tout["meta"][0] == "keep" and tout["loss"] == 1.5
    plain = {"a": [np.ones(3)], "b": (1, 2)}
    assert truntime._stage_to_host(plain) is plain
    t = torch.ones(4)
    assert truntime._stage_to_host(t) is t


def _jax_leaf(v):
    """The JAX reduce's leaf for a torch tensor: its numpy array; bf16 as
    its f32 values (see test_tree_reduce_matches_jax)."""
    if isinstance(v, torch.Tensor):
        return v.float().numpy() if v.dtype == torch.bfloat16 else \
            v.numpy()
    return v


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int8, torch.int32,
                                   torch.int64])
def test_tree_reduce_matches_jax(op, dtype):
    """``_tree_reduce`` over pytrees of torch leaves (three participants)
    against the JAX package's over the same values as numpy: the same
    dtype rule (f16 accumulates in f32 and casts back, small-int sums in
    int64 and cast back, integer means stay float64) and the same values,
    exactly for integers and to f32 rounding for floats. bf16 is held to
    the rule ``accumulation_dtype`` states (accumulate in f32, cast
    back): the JAX reduce of the same values in f32, rounded to bf16.
    The JAX reduce given ml_dtypes bf16 arrays adds them in bf16 step by
    step instead, because ``np.finfo`` refuses ml_dtypes' bfloat16 in
    this numpy, so its ``accumulation_dtype`` returns None for it."""
    from ray_tpu.dag.runtime import _tree_reduce as jreduce
    rng = np.random.default_rng(7)
    vals = []
    for _ in range(3):
        if dtype.is_floating_point:
            x = torch.from_numpy(rng.standard_normal((5, 4))
                                 .astype(np.float32)).to(dtype)
        else:
            lo, hi = (-100, 100) if dtype == torch.int8 else (-10**6, 10**6)
            x = torch.from_numpy(rng.integers(lo, hi, (5, 4))).to(dtype)
        vals.append({"w": x, "nt": NT(loss=float(rng.standard_normal()),
                                       grads=[x[:2]])})
    got = truntime._tree_reduce(op, vals)
    want = jreduce(op, [{"w": _jax_leaf(v["w"]),
                         "nt": NT(loss=v["nt"].loss,
                                  grads=[_jax_leaf(v["nt"].grads[0])])}
                        for v in vals])
    assert isinstance(got["nt"], NT)
    assert got["nt"].loss == pytest.approx(float(want["nt"].loss))
    for g, w in ((got["w"], want["w"]),
                 (got["nt"].grads[0], want["nt"].grads[0])):
        assert isinstance(g, torch.Tensor)
        if dtype == torch.bfloat16:
            assert g.dtype == dtype
            assert torch.equal(_bits(g), _bits(torch.from_numpy(
                np.asarray(w, np.float32)).to(dtype)))
        elif dtype.is_floating_point:
            assert g.dtype == dtype
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32),
                                       rtol=1.2e-7, atol=0)
        else:
            assert str(g.numpy().dtype) == str(w.dtype)
            assert np.array_equal(g.numpy(), w)


def test_tree_reduce_low_precision_accumulates_wide_on_torch():
    """The reference's fp16 and int8 cases on torch leaves: f16 sums in
    f32 (the sub-ulp addends survive), int8 sums in int64 (the partial
    overflow does not) and both cast back."""
    a = [torch.full((4,), v, dtype=torch.float16)
         for v in (1.0, 0.0004, 0.0004)]
    out = truntime._tree_reduce("sum", a)
    assert out.dtype == torch.float16
    assert out[0].item() == float(np.float16(np.float32(1.0008)))
    b = [torch.full((4,), v, dtype=torch.int8) for v in (100, 100, -100)]
    out = truntime._tree_reduce("sum", b)
    assert out.dtype == torch.int8 and int(out[0]) == 100
    d = [torch.tensor([1], dtype=torch.int32),
         torch.tensor([2], dtype=torch.int32)]
    out = truntime._tree_reduce("mean", d)
    assert out.dtype == torch.float64 and out[0].item() == 1.5


def test_star_allreduce_three_participants_on_torch_leaves(cluster):
    """``impl="star"`` keeps the star at three participants (the
    reference's rule): every participant sees the same sum, of bf16
    tensors accumulated in f32, and of numpy leaves."""

    @ray_tpu_torch.remote
    class Worker:
        def __init__(self, scale):
            self.scale = scale

        def grad(self, x):
            import torch
            return {"w": torch.full((8,), float(x) * self.scale,
                                    dtype=torch.bfloat16),
                    "b": np.full(2, self.scale)}

    ws = [Worker.remote(s) for s in (1.0, 10.0, 100.0)]
    with InputNode() as inp:
        out = MultiOutputNode(allreduce([w.grad.bind(inp) for w in ws],
                                        op="sum", impl="star"))
    cd = compile(out)
    try:
        for i in range(1, 3):
            vals = cd.execute(i).get(timeout=60)
            assert len(vals) == 3
            for v in vals:
                assert v["w"].dtype == torch.bfloat16
                assert torch.equal(v["w"], torch.full(
                    (8,), i * 111.0, dtype=torch.bfloat16))
                assert np.allclose(v["b"], 111.0)
    finally:
        cd.teardown()


@pytest.mark.parametrize("kw,n", [
    ({}, 3),                                   # no hint, N > 2: the ring
    ({"impl": "ring"}, 2),
    ({"impl": "hier"}, 2),                     # one node: the flat ring
    ({"quantize": "int8"}, 2),
    ({"payload_bytes": 8 * 1024 * 1024}, 2),   # above the star's limit
])
def test_ring_resolutions_raise_before_any_actor_is_pinned(cluster, kw, n):
    """Every group that resolves to a ring (each raised
    NotImplementedError from compile() until the ring was ported) now
    compiles to it and reduces: two rounds of a mean over a dict of a
    float32 vector, a bf16 tensor and an int, on every participant equal
    to the JAX package's reduce of the same values (dag/runtime.py
    ``_tree_reduce``; the int8 codec within its documented bound of it),
    the tensor back as a bf16 tensor; afterwards the actors answer plain
    calls again."""
    from ray_tpu.dag.ring import _flatten
    from ray_tpu.dag.runtime import _tree_reduce as jax_reduce
    from ray_tpu_torch.dag import _resolve_impl

    @ray_tpu_torch.remote
    class S:
        def __init__(self, seed):
            self.seed = seed

        def f(self, x):
            import numpy as np
            import torch
            rng = np.random.default_rng(self.seed + int(x))
            w = rng.standard_normal(3000).astype(np.float32)
            t = rng.integers(-64, 64, 40).astype(np.float32)
            return {"w": w, "t": torch.from_numpy(t).to(torch.bfloat16),
                    "n": self.seed + int(x)}

    def value(seed, x):
        rng = np.random.default_rng(seed + x)
        w = rng.standard_normal(3000).astype(np.float32)
        t = rng.integers(-64, 64, 40).astype(np.float32)
        return {"w": w, "t": t, "n": seed + x}

    assert _resolve_impl({"size": n, "op": "mean", **kw}) == "ring"
    ss = [S.remote(10 * i) for i in range(n)]
    with InputNode() as inp:
        out = MultiOutputNode(allreduce([s.f.bind(inp) for s in ss],
                                        op="mean", **kw))
    cd = compile(out)
    try:
        for x in (1, 2):
            vals = cd.execute(x).get(timeout=60)
            want = jax_reduce("mean", [value(10 * i, x) for i in range(n)])
            assert len(vals) == n
            for v in vals:
                assert v["t"].dtype == torch.bfloat16
                for key in ("w", "t"):
                    assert np.array_equal(np.asarray(v[key].float())
                                          if key == "t" else v[key],
                                          np.asarray(vals[0][key].float())
                                          if key == "t" else vals[0][key])
                assert v["n"] == want["n"]
            got_w = vals[0]["w"]
            if kw.get("quantize") == "int8":
                # a partial sum's block scale is at most the ranks' summed
                # max|value|/127 and each element rounds by half a scale
                # per hop (dag/ring.py): the mean's error stays below
                # that summed max/127
                bound = sum(max(np.abs(l).max() for l in _flatten(
                    [value(10 * i, x)["w"], value(10 * i, x)["t"]])[0])
                    for i in range(n)) / 127
                assert np.abs(got_w - want["w"]).max() <= bound
                assert np.abs(vals[0]["t"].float().numpy()
                              - want["t"]).max() <= bound + 0.5
            else:
                np.testing.assert_allclose(got_w, want["w"], rtol=1e-6,
                                           atol=1e-6)
                assert np.array_equal(
                    vals[0]["t"].float().numpy(),
                    torch.from_numpy(want["t"]).to(torch.bfloat16)
                    .float().numpy())
    finally:
        cd.teardown()
    try:
        assert ray_tpu_torch.get([s.f.remote(5) for s in ss],
                                 timeout=30)[0]["n"] == 5
    finally:
        for s in ss:     # the module's cluster budgets a CPU per actor
            ray_tpu_torch.kill(s)


def test_star_resolutions_follow_the_reference():
    """_resolve_impl gives the star wherever the reference's does."""
    from ray_tpu.dag import _resolve_impl as jresolve
    from ray_tpu_torch.dag import _resolve_impl
    for g in ({"size": 2}, {"size": 2, "payload_bytes": 1024},
              {"size": 5, "payload_bytes": 4 * 1024 * 1024},
              {"size": 4, "impl": "star"}, {"size": 1}):
        assert jresolve(dict(g)) == "star"
        assert _resolve_impl(dict(g)) == "star"


def test_ship_and_resolve_device_tree():
    """The device transport helpers: tensor leaves park as TensorRefs
    (bytes counted), resolve back to the same tensors and free
    themselves; an unwalkable container ships nothing and leaves nothing
    parked."""
    from ray_tpu_torch.runtime.device_store import TensorRef, _store
    before = _store().live_count()
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    y = torch.ones(5, dtype=torch.bfloat16)
    tree = {"a": [x, 3], "b": NT(loss=y, grads=(np.ones(2),))}
    shipped, nbytes = truntime._ship_device_tree(tree, ttl_s=60.0)
    assert nbytes == 12 * 4 + 5 * 2
    assert isinstance(shipped["a"][0], TensorRef)
    assert isinstance(shipped["b"].loss, TensorRef)
    assert _store().live_count() == before + 2
    back = truntime._resolve_device_tree(shipped)
    assert back["a"][0] is x and back["b"].loss is y
    assert back["a"][1] == 3 and isinstance(back["b"], NT)
    assert _store().live_count() == before
    odd = collections.defaultdict(list, {"t": x})
    assert truntime._ship_device_tree({"o": odd}, ttl_s=60.0) == \
        ({"o": odd}, 0)
    assert _store().live_count() == before


def test_cpu_tensors_ride_out_of_band():
    """The serializer carries a CPU tensor's bytes out of band (no copy
    into the pickle stream), bf16 included, and rebuilds it with its
    dtype and shape; a tensor that requires grad keeps torch's reduce."""
    from ray_tpu_torch.runtime.serialization import loads_oob, serialize
    t = torch.randn((256, 64)).to(torch.bfloat16)
    s = serialize({"x": t, "n": 1})
    assert len(s.inband) < 1024
    assert [b.nbytes for b in s.buffers] == [t.numel() * 2]
    back = loads_oob(s.to_bytes())
    assert back["n"] == 1 and back["x"].dtype == torch.bfloat16
    assert torch.equal(_bits(back["x"]), _bits(t))
    g = torch.randn(4, requires_grad=True)
    back = loads_oob(serialize(g).to_bytes())
    assert back.requires_grad and torch.equal(back.detach(), g.detach())


@pytest.mark.parametrize("nbytes", [64 << 10, 4 << 20],
                         ids=["inline", "shm"])
def test_deserialized_tensors_never_write_through(cluster, nbytes):
    """A tensor from get() or received as a task argument is the
    reader's own: an in-place op on it leaves the stored object as it
    was for every later reader, whether the object rides inline (a
    stored bytes frame) or in the node's shared memory."""
    import warnings
    t = torch.arange(nbytes // 4, dtype=torch.float32)
    ref = ray_tpu_torch.put(t)
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # no non-writable-buffer warning
        a = ray_tpu_torch.get(ref, timeout=60)
    a.add_(1.0)
    assert torch.equal(ray_tpu_torch.get(ref, timeout=60), t)

    @ray_tpu_torch.remote
    def bump(x):
        x.mul_(-1.0)
        return float(x[1])

    assert ray_tpu_torch.get(bump.remote(ref), timeout=60) == -1.0
    assert torch.equal(ray_tpu_torch.get(ref, timeout=60), t)


def test_tensors_from_writable_buffers_stay_zero_copy():
    """Over a writable frame (a ring slot read with zero_copy=True) the
    rebuilt tensor views the frame's memory; over a read-only one it is
    a writable copy."""
    from ray_tpu_torch.runtime.serialization import (Serialized,
                                                     deserialize, serialize)
    t = torch.arange(4096, dtype=torch.float32)
    frame = bytearray(serialize(t).to_bytes())
    view = deserialize(Serialized.from_buffer(frame))
    view.add_(1.0)
    assert torch.equal(deserialize(Serialized.from_buffer(frame)), t + 1)
    sealed = bytes(frame)
    own = deserialize(Serialized.from_buffer(sealed))
    own.zero_()
    assert torch.equal(deserialize(Serialized.from_buffer(sealed)), t + 1)


def test_tensor_aliasing_matches_torch_pickle():
    """Pins what sharing survives the trip, the same as torch's own
    reduce under pickle: one tensor object twice arrives as one object;
    a view of it arrives as an independent copy."""
    from ray_tpu_torch.runtime.serialization import loads_oob, serialize
    import pickle
    a = torch.arange(8192, dtype=torch.float32)
    value = [a, a, a[16:4096], a.view(64, 128)]
    ours = loads_oob(serialize(value).to_bytes())
    theirs = pickle.loads(pickle.dumps(value, protocol=5))
    for got in (ours, theirs):
        assert got[0] is got[1]
        got[0].add_(1.0)
        assert torch.equal(got[2], a[16:4096])
        assert torch.equal(got[3], a.view(64, 128))


def test_lazy_shm_consumer_keeps_a_frame_published_during_its_create(
        monkeypatch):
    """A lazy edge's consumer creates the segment while its producer
    polls for the name; the producer may attach and publish a frame
    before the consumer's constructor returns. That frame must still be
    the first one read: a reset of the sequence words after the create
    would drop it, and a ring would then read a data chunk as a
    header."""
    import uuid
    from multiprocessing import resource_tracker

    from ray_tpu_torch.dag.channel import DATA, attach_channel
    name = f"rtch-test-{uuid.uuid4().hex[:12]}"
    spec = {"name": name, "nslots": 4, "slot_bytes": 1024, "lazy": True}
    real = resource_tracker.register
    sent = []

    def register(shm_name, rtype):   # runs inside the consumer's create
        real(shm_name, rtype)
        if not sent and shm_name.lstrip("/") == name:
            sent.append(True)
            prod = attach_channel(spec, "producer", timeout=5.0)
            prod.write(b"header frame")
            prod.close()

    monkeypatch.setattr(resource_tracker, "register", register)
    cons = attach_channel(spec, "consumer", timeout=5.0)
    try:
        assert sent
        assert cons.read_bytes(timeout=1.0) == (DATA, b"header frame")
    finally:
        cons.close()
        cons.unlink()
