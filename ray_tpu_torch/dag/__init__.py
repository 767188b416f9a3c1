"""Compiled actor DAGs: pinned pipelines over shared-memory channels.

The compiled-graph analog (reference: python/ray/dag/compiled_dag_node.py:805,
dag/input_node.py, experimental/channel/shared_memory_channel.py): build a
static graph of actor method calls with `.bind()`, `compile()` it once —
every edge gets a pre-allocated SPSC shm ring, every actor enters a pinned
execution loop — then `execute()` streams items through with all stages
overlapped and bounded buffering for backpressure.

    with InputNode() as inp:
        h = stage1.fwd.bind(inp)
        out = stage2.fwd.bind(h)
    cd = compile(out)
    futs = [cd.execute(batch) for batch in batches]   # pipelined
    results = [f.get() for f in futs]
    cd.teardown()

Same-node edges ride POSIX shm rings (two memcpys, no RPC); cross-node
edges ride TCP channels with the same bounded-ring semantics
(dag/channel.py TcpChannel) — the DCN substrate for pipeline-parallel
inference across hosts/slices.

The port's copy of ``ray_tpu/dag/__init__.py``. A stage's CUDA tensors
are staged to host tensors before they enter a channel, and a stage
that returns ``TensorRef`` handles (runtime/device_store.py) ships only
the handles (dag/runtime.py). ``allreduce`` compiles to the star reduce
only: a group that would resolve to the chunked ring, the hierarchical
ring or the int8 codec raises ``NotImplementedError`` at ``compile()``,
before any actor is pinned (the gradient ring, ROADMAP Queue 1 item
13).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.dag.channel import (DATA, ERROR, STOP, ChannelTimeout,
                                 ShmRingChannel)
from ray_tpu_torch.runtime.serialization import dumps_oob, loads_oob, serialize

__all__ = ["InputNode", "MethodNode", "MultiOutputNode", "allreduce",
           "compile", "CompiledDag", "DagFuture"]


class InputNode:
    """Placeholder for the value passed to execute()."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class MethodNode:
    def __init__(self, handle, method: str, args: tuple):
        self.handle = handle
        self.method = method
        self.args = args

    def experimental_compile(self, **kw) -> "CompiledDag":
        return compile(self, **kw)


class MultiOutputNode:
    """Gathers several nodes' outputs into one list per executed item
    (reference: dag/output_node.py MultiOutputNode) — the sink shape for
    SPMD patterns where every participant's result matters, e.g.
    ``compile(MultiOutputNode(allreduce([...])))``."""

    def __init__(self, nodes):
        self.nodes = list(nodes)
        if not self.nodes:
            raise ValueError("MultiOutputNode needs at least one node")


class AllReduceNode:
    """Output of one participant in a dag collective. Created only by
    allreduce(); its value is the elementwise reduction of every
    participant's parent output for the same item."""

    def __init__(self, parent: MethodNode, group: dict, rank: int):
        self.parent = parent
        self.group = group
        self.rank = rank


_REDUCE_OPS = ("sum", "mean", "max", "min")


def allreduce(nodes, op: str = "sum", *, quantize: Optional[str] = None,
              chunk_bytes: Optional[int] = None,
              impl: Optional[str] = None,
              payload_bytes: Optional[int] = None):
    """Bind an allreduce across DAG actors (reference:
    dag/collective_node.py:252 + experimental/collective/operations.py —
    which lower to NCCL; here the collective rides the host object plane
    over the same placement-aware channels as data edges, shm when
    co-located, TCP across nodes. Within one process holding a mesh,
    tensor reductions belong to jit'd psum over ICI, not the DAG).

    The reference compiles groups of more than two participants to a
    chunked ring reduce-scatter + allgather (dag/ring.py), optionally
    int8-quantized or as a ring-of-rings across nodes; the port has the
    star reduce only (rank 0 hosts the reduce, every other participant
    sends up and receives the result down). The arguments are the
    reference's and validated alike; ``compile()`` resolves each group
    as the reference does (``_resolve_impl``) and raises
    ``NotImplementedError`` naming ROADMAP Queue 1 item 13 for every
    group that resolves to a ring: an explicit ``impl="ring"`` or
    ``"hier"``, ``quantize="int8"``, a ``payload_bytes`` hint above
    ``Config.allreduce_star_max_bytes``, or more than two participants
    with neither a hint nor ``impl="star"``. ``chunk_bytes`` is the
    ring's and so unused here.

    Takes one upstream MethodNode per participant actor; returns one
    AllReduceNode per participant, each carrying the reduced value. The
    raw parent outputs are consumed by the collective and cannot also be
    bound elsewhere."""
    nodes = list(nodes)
    if len(nodes) < 2:
        raise ValueError("allreduce needs at least 2 participants")
    if op not in _REDUCE_OPS:
        raise ValueError(f"op must be one of {_REDUCE_OPS}, got {op!r}")
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', "
                         f"got {quantize!r}")
    if impl not in (None, "auto", "star", "ring", "hier"):
        raise ValueError(f"impl must be None, 'auto', 'star', 'ring' "
                         f"or 'hier', got {impl!r}")
    if impl == "star" and quantize is not None:
        raise ValueError("the star reduce does not support quantize; "
                         "use impl='ring' (or leave impl unset)")
    if payload_bytes is not None and payload_bytes < 0:
        raise ValueError("payload_bytes must be >= 0")
    for n in nodes:
        if not isinstance(n, MethodNode):
            raise TypeError(
                "allreduce participants must be bound method nodes")
    import uuid as _uuid
    group = {"id": _uuid.uuid4().hex[:16], "op": op, "size": len(nodes),
             "quantize": quantize, "chunk_bytes": chunk_bytes,
             "impl": impl, "payload_bytes": payload_bytes,
             "members": []}
    out = [AllReduceNode(n, group, rank) for rank, n in enumerate(nodes)]
    group["members"] = out
    return out


def _resolve_impl(group: dict) -> str:
    """The topology of one collective group, resolved at compile time
    by the reference's rules (explicit impl wins; quantize forces a
    ring; a payload hint compares with Config.allreduce_star_max_bytes;
    no hint falls back to group size). The port has only the star:
    every other resolution raises NotImplementedError naming ROADMAP
    Queue 1 item 13. The reference's in-situ tuner (dag/tuner.py)
    refines the hinted choice between star and ring; it comes with the
    ring."""
    impl = group.get("impl")

    def ring(why: str):
        raise NotImplementedError(
            f"allreduce: {why} resolves to the chunked ring collective, "
            "which is not ported to ray_tpu_torch yet (ROADMAP Queue 1 "
            "item 13: dag/ring.py); the port has impl='star' only")
    if impl == "star":
        return "star"
    if impl in ("ring", "hier"):
        ring(f"impl={impl!r}")
    if group["size"] < 2:
        return "star"            # a ring needs two ranks to exist
    if group.get("quantize"):
        ring(f"quantize={group['quantize']!r}")
    pb = group.get("payload_bytes")
    if pb is not None:
        from ray_tpu_torch.config import get_config
        thr = getattr(get_config(), "allreduce_star_max_bytes",
                      4 * 1024 * 1024)
        if pb <= thr:
            return "star"
        ring(f"payload_bytes={pb} (above allreduce_star_max_bytes="
             f"{thr})")
    if group["size"] > 2:
        ring(f"a group of {group['size']} participants with no "
             "payload_bytes hint")
    return "star"


class DagFuture:
    def __init__(self, dag: "CompiledDag", seq: int):
        self._dag = dag
        self._seq = seq

    def get(self, timeout: Optional[float] = None) -> Any:
        return self._dag._result(self._seq, timeout)


class CompiledDag:
    def __init__(self, sink, *, nslots: int, slot_bytes: int,
                 zero_copy: bool = False, overlap: bool = True,
                 collective_timeout_s: float = 600.0):
        self._coll_timeout = collective_timeout_s
        if isinstance(sink, MultiOutputNode):
            self._sink_members = list(sink.nodes)
            self._unwrap_single = False   # 1-member MultiOutput -> [v]
        elif isinstance(sink, (MethodNode, AllReduceNode)):
            self._sink_members = [sink]
            self._unwrap_single = True
        else:
            raise TypeError("compile() expects the dag's output node")
        for m in self._sink_members:
            if not isinstance(m, (MethodNode, AllReduceNode)):
                raise TypeError(
                    "MultiOutputNode members must be dag nodes")
        self._nslots = nslots
        self._slot_bytes = slot_bytes
        self._zero_copy = zero_copy
        self._overlap = overlap and not zero_copy
        self._nodes: List[MethodNode] = []
        self._groups: List[dict] = []       # allreduce groups in the dag
        self._groups_seen = set()
        seen = set()
        for m in self._sink_members:
            self._topo(m, seen)
        for g in self._groups:       # raises before any actor is touched
            _resolve_impl(g)
        self._validate()
        self._channels: List[ShmRingChannel] = []
        # edge channels: producer node -> list of (consumer, arg position)
        self._in_chans: Dict[int, List[dict]] = {}   # node idx -> specs
        self._templates: Dict[int, list] = {}
        self._out_chans: Dict[int, List[dict]] = {}
        self._input_chans: List[ShmRingChannel] = []
        self._sink_chans: List = []
        self._coll_spec: Dict[int, dict] = {}        # node idx -> role spec
        self._build()
        self._loops = []
        self.stage_stats: Optional[List[dict]] = None
        self._start()
        self._next_seq = 0
        self._read_seq = 0
        self._results: Dict[int, list] = {}
        self._sink_bufs: List[list] = [[] for _ in self._sink_chans]
        self._lock = threading.Lock()
        self._torn_down = False

    # --- graph wiring ---------------------------------------------------

    def _topo(self, node, seen):
        if isinstance(node, AllReduceNode):
            # Reaching ANY participant pulls in the WHOLE group: every
            # member's parent must run a loop or the collective hangs.
            g = node.group
            if g["id"] not in self._groups_seen:
                self._groups_seen.add(g["id"])
                self._groups.append(g)
                for m in g["members"]:
                    self._topo(m.parent, seen)
            return
        if id(node) in seen or not isinstance(node, MethodNode):
            return
        seen.add(id(node))
        for a in node.args:
            self._topo(a, seen)
        self._nodes.append(node)  # post-order == topological

    def _validate(self):
        """Reject dag shapes that would hang opaquely at runtime, and
        record each node's placement: same-node edges get shm rings,
        cross-node edges get TCP channels (the DCN substrate for
        pipeline-parallel inference across hosts/slices — reference:
        experimental/channel/ crosses nodes via plasma + torch channel;
        here a credit-windowed socket preserves ring semantics)."""
        from ray_tpu_torch.api import _require_init, _run
        ctx = _require_init()
        self._driver_node = ctx.node_id
        self._node_placement = []      # node idx -> cluster node_id
        seen_actors = set()
        for n in self._nodes:
            aid = n.handle._actor_id
            if aid in seen_actors:
                # One pinned loop holds the actor's lock + executor
                # thread for its lifetime; a second would never start.
                raise ValueError(
                    "compiled dags pin one exec loop per actor — use a "
                    "distinct actor for each dag node")
            seen_actors.add(aid)
            _run(ctx.pool.call(ctx.head_addr, "wait_actor_alive",
                               actor_id=aid, wait_timeout=60.0))
            info = _run(ctx.pool.call(ctx.head_addr, "get_actor",
                                      actor_id=aid))
            self._node_placement.append(
                (info or {}).get("node_id") or ctx.node_id)
        # Collective participants: the raw parent output is consumed by
        # the reduce — binding it elsewhere too would need a second fan-out
        # edge carrying the UNreduced value, which allreduce() forbids.
        parents = {}
        for g in self._groups:
            for m in g["members"]:
                if id(m.parent) in parents:
                    raise ValueError(
                        "a node cannot participate in two allreduce groups")
                parents[id(m.parent)] = g["id"]
        if parents:
            consumers = [a for n in self._nodes for a in n.args]
            consumers += self._sink_members
            for a in consumers:
                if isinstance(a, MethodNode) and id(a) in parents:
                    raise ValueError(
                        "a collective participant's raw output cannot be "
                        "bound downstream — bind its AllReduceNode instead")
        # Shape checks belong HERE, before _build creates any channel:
        # raising mid-build would leak shm segments / TCP listeners
        # (CompiledDag.__init__ aborts with nothing to teardown).
        sink_nodes = [m.parent if isinstance(m, AllReduceNode) else m
                      for m in self._sink_members]
        if len({id(n) for n in sink_nodes}) != len(sink_nodes):
            raise ValueError(
                "the same node cannot appear twice in MultiOutputNode")

    def _local(self, i: Optional[int]) -> bool:
        """True when dag node i (None = the driver) runs on the
        driver's cluster node — only then is a POSIX shm ring valid
        (created driver-side, attached by name)."""
        return i is None or self._node_placement[i] == self._driver_node

    def _new_edge(self, producer: Optional[int],
                  consumer: Optional[int]) -> dict:
        """Channel spec for one edge; driver-owned endpoints are
        constructed eagerly (shm segment, or the tcp endpoint for the
        driver's side of a cross-node edge). Co-located NON-driver
        stages get a lazily-created shm ring (consumer creates it at
        attach); only genuinely cross-node edges pay TCP."""
        import uuid as _uuid

        from ray_tpu_torch.dag.channel import TcpChannel, new_tcp_spec
        if self._local(producer) and self._local(consumer):
            ch = ShmRingChannel(create=True, nslots=self._nslots,
                                slot_bytes=self._slot_bytes)
            self._channels.append(ch)
            if producer is None:
                self._input_chans.append(ch)
            if consumer is None:
                self._sink_chans.append(ch)
            return ch.spec()
        if producer is not None and consumer is not None and \
                self._node_placement[producer] == \
                self._node_placement[consumer]:
            # same remote node: shm ring created by the consumer side
            return {"name": f"rtch-{_uuid.uuid4().hex[:16]}",
                    "nslots": self._nslots,
                    "slot_bytes": self._slot_bytes, "lazy": True}
        spec = new_tcp_spec(self._nslots, self._slot_bytes)
        if producer is None:
            # nonblocking: the driver must always be able to return to
            # draining the sink (it is the sink's only reader); frames
            # enqueue under credit and flush from the sink pump
            ch = TcpChannel(spec, "producer", nonblocking_writes=True)
            self._channels.append(ch)
            self._input_chans.append(ch)
        if consumer is None:
            ch = TcpChannel(spec, "consumer")  # publishes endpoint now
            self._channels.append(ch)
            self._sink_chans.append(ch)
        return spec

    def _build(self):
        idx = {id(n): i for i, n in enumerate(self._nodes)}
        for i, n in enumerate(self._nodes):
            self._in_chans[i] = []
            self._out_chans[i] = []
            self._templates[i] = []
        for i, n in enumerate(self._nodes):
            for a in n.args:
                if isinstance(a, InputNode):
                    spec = self._new_edge(None, i)
                    self._in_chans[i].append(spec)
                    self._templates[i].append(("chan", None))
                elif isinstance(a, (MethodNode, AllReduceNode)):
                    # An AllReduceNode's value leaves from its PARENT's
                    # loop (the reduce happens in-loop before writes).
                    src = idx[id(a.parent)] if isinstance(a, AllReduceNode) \
                        else idx[id(a)]
                    spec = self._new_edge(src, i)
                    self._out_chans[src].append(spec)
                    self._in_chans[i].append(spec)
                    self._templates[i].append(("chan", None))
                else:
                    self._templates[i].append(("const", dumps_oob(a)))
        # collective wiring: the star (every group resolved to it in
        # __init__). Rank 0 hosts the reduce; every other participant
        # sends up and receives the result down.
        for g in self._groups:
            idxs = [idx[id(m.parent)] for m in g["members"]]
            root = idxs[0]
            root_spec = {"role": "root", "op": g["op"], "size": g["size"],
                         "timeout_s": self._coll_timeout,
                         "up": [], "down": []}
            for leaf in idxs[1:]:
                up = self._new_edge(leaf, root)
                down = self._new_edge(root, leaf)
                root_spec["up"].append(up)
                root_spec["down"].append(down)
                self._coll_spec[leaf] = {"role": "leaf", "op": g["op"],
                                         "size": g["size"],
                                         "timeout_s": self._coll_timeout,
                                         "up": up, "down": down}
            self._coll_spec[root] = root_spec
        # sinks -> driver: one channel per member, combined in lockstep
        # (duplicates were rejected in _validate, before channels exist)
        for m in self._sink_members:
            si = idx[id(m.parent)] if isinstance(m, AllReduceNode) \
                else idx[id(m)]
            self._out_chans[si].append(self._new_edge(si, None))

    def _start(self):
        from ray_tpu_torch.api import ActorMethod
        for i, n in enumerate(self._nodes):
            spec = {"method": n.method,
                    "in_channels": self._in_chans[i],
                    "arg_template": self._templates[i],
                    "out_channels": self._out_chans[i],
                    "zero_copy": self._zero_copy,
                    "overlap": self._overlap,
                    "collective": self._coll_spec.get(i)}
            # retries pinned to 0: a replayed loop would attach a second
            # consumer to SPSC rings and race on the sequence counters.
            m = ActorMethod(n.handle, "__dag_exec_loop__",
                            max_task_retries=0)
            self._loops.append(m.remote(spec))

    # --- execution ------------------------------------------------------

    def execute(self, value: Any,
                timeout: Optional[float] = None) -> DagFuture:
        """Feed one item; returns a future. When the input ring is full,
        completed results are drained off the sink while waiting — so
        submitting arbitrarily many items ahead of get() can't deadlock
        the pipeline (driver blocked on full input ↔ stages blocked on
        an unread sink)."""
        if self._torn_down:
            raise RuntimeError("dag torn down")
        ser = serialize(value)
        deadline = None if timeout is None else time.monotonic() + timeout
        # Wait for space on ALL input rings BEFORE writing any: a partial
        # write followed by a timeout would leave fan-in channels skewed,
        # silently pairing mismatched items forever after. Space only
        # grows (the consumers are the stages), so write-after-check
        # cannot block.
        while not all(ch.has_space() for ch in self._input_chans):
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeout("input ring full")
            with self._lock:
                self._pump_sink(blocking=False)
            time.sleep(200e-6)
        for ch in self._input_chans:
            ch.write(ser, DATA)
        seq = self._next_seq
        self._next_seq += 1
        return DagFuture(self, seq)

    def _pump_sink(self, blocking: bool, timeout: Optional[float] = None):
        """Move any completed frames sink -> _results. Caller holds
        self._lock. Also flushes any enqueued (nonblocking) input
        frames — the pump is the driver's one guaranteed-periodic
        touchpoint, so a tail frame can never starve unflushed."""
        for ch in self._input_chans:
            if hasattr(ch, "flush"):
                try:
                    ch.flush(0.0)
                except Exception:
                    pass   # surfaced by the next write/get on that edge
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            # complete ONE seq: a frame from EVERY sink channel, in
            # lockstep (partial fills survive a timeout in _sink_bufs)
            for j, ch in enumerate(self._sink_chans):
                if self._sink_bufs[j]:
                    continue
                if blocking:
                    left = None if deadline is None else \
                        max(deadline - time.monotonic(), 0.0)
                    self._sink_bufs[j].append(ch.read_bytes(left))
                else:
                    try:
                        self._sink_bufs[j].append(ch.read_bytes(0.0))
                    except ChannelTimeout:
                        return
            frames = [buf.pop(0) for buf in self._sink_bufs]
            if any(k == STOP for k, _ in frames):
                raise RuntimeError("dag torn down mid-stream")
            self._results[self._read_seq] = frames
            self._read_seq += 1
            if blocking:
                return

    def _result(self, seq: int, timeout: Optional[float]) -> Any:
        with self._lock:
            while seq not in self._results:
                self._pump_sink(blocking=True, timeout=timeout)
        frames = self._results.pop(seq)
        for kind, payload in frames:
            if kind == ERROR:
                err = loads_oob(payload)
                raise err if isinstance(err, BaseException) else \
                    RuntimeError(str(err))
        vals = [loads_oob(p) for _, p in frames]
        return vals[0] if self._unwrap_single else vals

    def teardown(self, timeout: float = 30.0):
        if self._torn_down:
            return
        self._torn_down = True
        deadline = time.monotonic() + timeout
        from ray_tpu_torch import api
        from ray_tpu_torch.dag.channel import ChannelClosed
        stop_seen = [False] * len(self._sink_chans)

        def _drain_sinks(block_s: float):
            """Pull whatever sits in the sinks; mark channels whose STOP
            arrived. Draining is what unwinds a wedged pipeline: stages
            blocked writing results into a full sink must unblock to
            ever see the STOP — otherwise their loops would spin
            (holding the actor's executor thread) against channels we
            are about to unlink."""
            for j, ch in enumerate(self._sink_chans):
                if stop_seen[j]:
                    continue
                wait = block_s
                try:
                    while True:
                        kind, _ = ch.read_bytes(wait)
                        if kind == STOP:
                            stop_seen[j] = True
                            break
                        wait = 0.0   # opportunistic after the first
                except ChannelTimeout:
                    pass
                except ChannelClosed:
                    stop_seen[j] = True   # stage died: nothing more

        # Phase 1: place STOP on every input edge. A wedged pipeline
        # (stage blocked writing a full sink -> prefetch queue full ->
        # reader not consuming -> input ring full) only unwinds if the
        # sink is drained WHILE trying — never burn the whole budget
        # blocking on one full input ring.
        pending_stop = list(self._input_chans)
        while pending_stop and time.monotonic() < deadline:
            for ch in list(pending_stop):
                try:
                    ch.write(b"", STOP, timeout=0.2)
                    if hasattr(ch, "flush"):
                        ch.flush(0.0)
                    pending_stop.remove(ch)
                except ChannelTimeout:
                    pass                      # ring still full: drain more
                except ChannelClosed:
                    pending_stop.remove(ch)   # consumer stage is gone
            _drain_sinks(0.0)
        # Phase 2: drain until STOP flows out of every sink.
        while not all(stop_seen) and time.monotonic() < deadline:
            _drain_sinks(0.5)
        try:
            # Keep the per-stage results: timing/overlap stats
            # ({processed, timing, items}) readable via stage_stats.
            self.stage_stats = api.get(
                self._loops, timeout=max(1.0, deadline - time.monotonic()))
        except Exception:
            pass
        for ch in self._channels:
            ch.close()
            ch.unlink()

    def __del__(self):
        try:
            self.teardown(timeout=1.0)
        except Exception:
            pass


def compile(sink, *, nslots: int = 8,
            slot_bytes: int = 4 << 20,
            zero_copy: bool = False,
            overlap: bool = True,
            collective_timeout_s: float = 600.0) -> CompiledDag:
    """zero_copy=True deserializes single-input stage args directly from
    the ring slot (no copy) — only safe when stage methods do NOT retain
    references to their array arguments past the call (and disables
    overlap: the slot window cannot outlive a prefetch).

    overlap=True (default) compiles each stage to an overlapped operation
    schedule — a reader thread prefetches the NEXT item's inputs while
    the current item computes (reference: dag/dag_node_operation.py:86
    compiles per-actor READ/COMPUTE/WRITE schedules for the same reason).
    Cross-node TCP receives hide under compute; per-item recv/compute
    spans land in the trace and in CompiledDag.stage_stats."""
    return CompiledDag(sink, nslots=nslots, slot_bytes=slot_bytes,
                       zero_copy=zero_copy, overlap=overlap,
                       collective_timeout_s=collective_timeout_s)
