"""Worker-side pinned execution loop for compiled DAGs.

The analog of the reference's compiled-graph executor schedule (reference:
python/ray/dag/dag_node_operation.py:86 — each actor's node is compiled
into READ/COMPUTE/WRITE operations that overlap channel I/O with compute;
compiled_dag_node.py:805 _execute_until): each pinned actor runs an
operation schedule per item — a reader thread prefetches the NEXT item's
inputs (TCP receives hide under compute), the executor thread runs the
bound method, participates in any collective, and pushes downstream.
Per-item recv/compute windows are recorded (trace spans + a timing block
in the loop result) so overlap is measurable, not asserted.

The port's copy of ``ray_tpu/dag/runtime.py``'s ``exec_loop`` and its
star collective, with the device transport on torch: a CUDA tensor in a
stage's result, bare or inside dicts, lists, tuples and NamedTuples, is
staged to a CPU tensor of the same dtype and shape (bf16 stays bf16)
before it enters the channel — the counterpart of the reference's
``np.asarray(jax.Array)`` (reference:
experimental/rdt/tensor_transport_manager.py:37). A method that returns
``TensorRef`` handles (runtime/device_store.py) opts into the device
transport instead: only the handles ride the channel. The star reduce
(``_tree_reduce``) takes torch and numpy leaves alike. The ring and
hierarchical collectives and ``pipe_exec_loop`` (train/pipeline.py's
stage loop) wait for ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

import queue as _queue
import sys
import threading
import time
from typing import List, Optional

import numpy as np

from ray_tpu_torch.dag.channel import (DATA, ERROR, STOP, ChannelClosed,
                                       ChannelTimeout, ShmRingChannel,
                                       attach_channel)
from ray_tpu_torch.runtime.serialization import (dumps_oob, loads_oob,
                                                 serialize)

_MAX_TIMED_ITEMS = 512   # per-item windows kept for overlap analysis


_TENSOR_T = None        # cached torch.Tensor (resolved once per process
                        # instead of per staged value)


def _tensor_type():
    """torch.Tensor, or None while this process has not loaded torch (a
    value can then hold no tensor: nothing to stage or park). The DAG
    never imports torch itself."""
    global _TENSOR_T
    if _TENSOR_T is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return None
        _TENSOR_T = torch.Tensor
    return _TENSOR_T


def _stage_to_host(value):
    """CUDA tensor leaves — bare or inside dict/list/tuple/NamedTuple
    results — are host-staged into the channel as CPU tensors of the same
    dtype and shape; a method that returns TensorRefs
    (runtime/device_store.py put_device) opts into the device transport
    instead — only the small handle rides the channel and the tensor
    moves on first resolution (zero-copy within a process)."""
    if _tensor_type() is None:
        return value     # no torch in-process: nothing to stage
    return _stage_tree(value)


def _stage_tree(value):
    if isinstance(value, _TENSOR_T):
        return value.detach().cpu() if value.is_cuda else value
    if isinstance(value, dict):
        staged = {k: _stage_tree(v) for k, v in value.items()}
        if any(staged[k] is not value[k] for k in staged):
            if type(value) is dict:
                return staged
            try:
                return type(value)(staged)
            except TypeError:    # subclass ctor isn't mapping-shaped
                return value     # (defaultdict etc.): leave unstaged
        return value
    if isinstance(value, (list, tuple)):
        staged = [_stage_tree(v) for v in value]
        if any(s is not v for s, v in zip(staged, value)):
            try:
                if isinstance(value, tuple) and hasattr(value, "_fields"):
                    return type(value)(*staged)     # NamedTuple
                return type(value)(staged)
            except TypeError:
                return value     # exotic sequence ctor: leave unstaged
        return value
    return value


class _Stop(Exception):
    pass


class _Upstream(Exception):
    """An ERROR frame arrived; carry it downstream unchanged."""

    def __init__(self, frame: bytes):
        self.frame = frame


class _ReaderDead(Exception):
    """The prefetch reader hit a channel error (peer death/teardown):
    terminal for the loop — nobody will produce another round."""

    def __init__(self, cause: BaseException):
        self.cause = cause




# --- collective (host-plane star reduce) --------------------------------


def _numpy_standin(dtype) -> np.dtype:
    """The numpy dtype whose reduce policy a torch dtype shares
    (dag/ring.py accumulation_dtype): floats narrower than 32 bits that
    numpy lacks (bfloat16, the fp8 types) take float16's, which is
    theirs in the reference (ml_dtypes floats accumulate in float32)."""
    import torch
    if dtype.is_floating_point and dtype.itemsize < 4:
        return np.dtype(np.float16)
    return torch.empty(0, dtype=dtype).numpy().dtype


def _reduce_tensors(op: str, vals: list):
    """``_tree_reduce`` on torch leaves, by the numpy path's policy:
    sub-32-bit floats and sub-64-bit integer sums accumulate wide and
    cast back; integer means are float64 results."""
    import torch

    from ray_tpu_torch.dag.ring import _keeps_wide, accumulation_dtype
    ts = [torch.as_tensor(v) for v in vals]
    dt = ts[0].dtype
    std = _numpy_standin(dt)
    acc_np = accumulation_dtype(std, op)
    acc = None if acc_np is None else \
        torch.from_numpy(np.empty(0, acc_np)).dtype
    out = ts[0] if acc is None else ts[0].to(acc)
    for t in ts[1:]:
        if op in ("sum", "mean"):
            out = out + (t if acc is None else t.to(acc))
        elif op == "max":
            out = torch.maximum(out, t)
        else:
            out = torch.minimum(out, t)
    if op == "mean":
        if not (out.is_floating_point() or out.is_complex()):
            out = out.double()   # numpy's int / len is float64
        out = out / len(ts)
    if acc is not None and not _keeps_wide(std, op):
        out = out.to(dt)
    return out


def _tree_reduce(op: str, vals: list):
    """Elementwise reduce over matching pytrees of arrays/tensors/
    scalars. Host plane (reference lowers collective nodes to NCCL
    allreduce, dag/collective_node.py:252). Low-precision leaves
    accumulate wide (the policy of dag/ring.py accumulation_dtype) and
    cast back to the input dtype at the end — except integer means,
    which stay float64 like a stepwise numpy division would. A torch
    leaf reduces with torch ops (bf16 has no numpy dtype), any other
    leaf through numpy, as in the reference."""
    from ray_tpu_torch.dag.ring import _keeps_wide, accumulation_dtype
    v0 = vals[0]
    if isinstance(v0, dict):
        return {k: _tree_reduce(op, [v[k] for v in vals]) for k in v0}
    if isinstance(v0, tuple) and hasattr(v0, "_fields"):   # NamedTuple
        return type(v0)(*(
            _tree_reduce(op, [v[i] for v in vals])
            for i in range(len(v0))))
    if isinstance(v0, (list, tuple)):
        return type(v0)(
            _tree_reduce(op, [v[i] for v in vals])
            for i in range(len(v0)))
    tensor_t = _tensor_type()
    if tensor_t is not None and isinstance(v0, tensor_t):
        return _reduce_tensors(op, vals)
    arrs = [np.asarray(v) for v in vals]
    acc = accumulation_dtype(arrs[0].dtype, op)
    out = arrs[0] if acc is None else arrs[0].astype(acc)
    for a in arrs[1:]:
        if op in ("sum", "mean"):
            out = out + (a if acc is None else a.astype(acc))
        elif op == "max":
            out = np.maximum(out, a)
        else:
            out = np.minimum(out, a)
    if op == "mean":
        out = out / len(arrs)
    if acc is not None and not _keeps_wide(arrs[0].dtype, op):
        out = out.astype(arrs[0].dtype)
    return out


class _Collective:
    """One participant's view of a dag allreduce group: the star (roles
    "root"/"leaf"; root ingress+egress O(N*S)). Every data round EVERY
    participant enters the round (with its value, or with the ERROR
    frame it would have shipped) — peers must never be left blocking in
    a reduce because one participant failed. Reads are bounded by
    `timeout_s` (shm rings carry no peer-death signal): a dead/killed
    peer surfaces as a terminal stall instead of pinning this actor's
    executor thread forever. The reference's ring roles ("ring",
    "hier") and their standalone reduce_scatter/allgather wait for
    ROADMAP Queue 1 item 13; compile() never wires them here."""

    def __init__(self, spec: dict):
        self.role = spec["role"]
        self.op = spec["op"]
        self.timeout_s = float(spec.get("timeout_s", 600.0))
        if self.role == "root":
            self.up = [attach_channel(s, "consumer") for s in spec["up"]]
            self.down = [attach_channel(s, "producer")
                         for s in spec["down"]]
        elif self.role == "leaf":
            self.up = [attach_channel(spec["up"], "producer")]
            self.down = [attach_channel(spec["down"], "consumer")]
        else:
            raise NotImplementedError(
                f"collective role {self.role!r}: the ring collectives "
                "are not ported to ray_tpu_torch yet (ROADMAP Queue 1 "
                "item 13)")

    def channels(self) -> list:
        return self.up + self.down

    def round(self, kind: int, value, err_frame: Optional[bytes]):
        """Returns (DATA, reduced_frame) or (ERROR, frame). The reduced
        value travels onward as the already-encoded frame — participants
        forward it downstream without a second serialize/deserialize."""
        try:
            if self.role == "leaf":
                if kind == DATA:
                    self.up[0].write(serialize(value), DATA,
                                     timeout=self.timeout_s)
                else:
                    self.up[0].write(err_frame, ERROR,
                                     timeout=self.timeout_s)
                return self.down[0].read_bytes(self.timeout_s)
        except (ChannelTimeout, ChannelClosed) as e:
            raise _ReaderDead(RuntimeError(
                f"allreduce peer unresponsive for {self.timeout_s}s "
                f"(participant died?): {e}"))
        # root: gather every leaf's contribution, reduce, broadcast
        contribs = []
        err = err_frame if kind == ERROR else None
        for ch in self.up:
            try:
                k, p = ch.read_bytes(self.timeout_s)
            except (ChannelTimeout, ChannelClosed) as e:
                raise _ReaderDead(RuntimeError(
                    f"allreduce peer unresponsive for {self.timeout_s}s "
                    f"(participant died?): {e}"))
            if k == ERROR:
                err = err or p
            else:
                contribs.append(loads_oob(p))
        if err is not None:
            for ch in self.down:
                ch.write(err, ERROR)
            return (ERROR, err)
        try:
            red = _tree_reduce(self.op, [value] + contribs)
            ser = serialize(red)
        except BaseException as e:  # noqa: BLE001 — reduce failed
            # e.g. mismatched pytree keys: the leaves are all parked on
            # their down channels — broadcast the failure so they raise
            # it this round instead of blocking for collective timeout_s
            # with the group desynced
            try:
                frame = dumps_oob(e)
            except Exception:   # unpicklable exception payload
                frame = dumps_oob(RuntimeError(
                    f"{type(e).__name__}: {e}"))
            for ch in self.down:
                ch.write(frame, ERROR)
            return (ERROR, frame)
        for ch in self.down:
            ch.write(ser, DATA)
        return (DATA, ser)


# --- the loop -----------------------------------------------------------


def exec_loop(instance, spec: dict) -> dict:
    """Runs inside the actor's executor thread until a STOP frame.

    spec:
      method: attribute name on the actor instance
      in_channels: list of channel specs (one per bound upstream arg)
      arg_template: list where each element is ("chan", idx) or
        ("const", frame) — positional args in order
      out_channels: list of channel specs (broadcast to every consumer)
      overlap: prefetch next item's inputs on a reader thread
      collective: optional allreduce role spec (see _Collective)
    """
    method = getattr(instance, spec["method"])
    # shm rings attach by name (same host); tcp edges bind/connect per
    # role — this stage CONSUMES its in-edges, PRODUCES its out-edges
    ins: List[ShmRingChannel] = [
        attach_channel(s, "consumer") for s in spec["in_channels"]]
    outs: List[ShmRingChannel] = [
        attach_channel(s, "producer") for s in spec["out_channels"]]
    coll = _Collective(spec["collective"]) if spec.get("collective") \
        else None
    template = [loads_oob(frame) if k == "const" else None
                for k, frame in spec["arg_template"]]
    chan_pos = [i for i, (k, _) in enumerate(spec["arg_template"])
                if k == "chan"]
    # Zero-copy is opt-in (compile(zero_copy=True)): args alias the ring
    # slot, which is only safe when the method does not retain them —
    # and incompatible with both prefetch (the window would escape) and
    # collectives (the value must outlive the slot for the reduce).
    single = len(ins) == 1 and spec.get("zero_copy") and coll is None
    overlap = bool(spec.get("overlap")) and not single and ins

    from ray_tpu_torch.util import tracing
    items: List[dict] = []          # first N per-item timing windows
    # recv windows span WAIT + transfer (channels expose no first-byte
    # mark): overlapped_recv_s is the receive-side blocking hidden under
    # compute — the overlap the schedule creates — not pure wire time;
    # an upstream-starved stage shows long recv spans by design.
    stats = {"recv_s": 0.0, "compute_s": 0.0, "overlapped_recv_s": 0.0}

    def _run_in_window(kind, mv):
        """Zero-copy fast path: the method consumes the frame AND the
        result is serialized downstream INSIDE the slot window, so
        deserialization is zero-copy (arrays alias the ring slot —
        even a method returning a view of its input stays safe, since
        the slot is released only after the downstream copy)."""
        if kind != DATA:
            raise _Stop() if kind == STOP else _Upstream(bytes(mv))
        args = list(template)
        args[chan_pos[0]] = loads_oob(mv)
        ser = serialize(_stage_to_host(method(*args)))
        for out in outs:
            out.write(ser, DATA)

    # --- overlapped reader: prefetches whole input rounds ---------------
    rounds_q: Optional[_queue.Queue] = None
    reader: Optional[threading.Thread] = None
    if overlap:
        rounds_q = _queue.Queue(maxsize=2)

        def _read_rounds():
            while True:
                t0 = time.time()
                frames = []
                for ch in ins:
                    try:
                        frames.append(ch.read_bytes())
                    except BaseException as e:  # noqa: BLE001
                        rounds_q.put(("fail", e, (t0, time.time())))
                        return
                rounds_q.put(("round", frames, (t0, time.time())))
                if any(k == STOP for k, _ in frames):
                    return   # lockstep: STOP reaches every edge together

        reader = threading.Thread(target=_read_rounds, daemon=True,
                                  name="dag-prefetch")
        reader.start()

    def _next_round():
        """One input round: [(kind, payload)] per in-channel + the recv
        window. Raises what a direct read would raise."""
        if overlap:
            tag, payload, win = rounds_q.get()
            if tag == "fail":
                raise _ReaderDead(payload)
            return payload, win
        t0 = time.time()
        try:
            frames = [ch.read_bytes() for ch in ins]
        except BaseException as e:  # channel death: terminal, like the
            raise _ReaderDead(e)    # prefetch reader's fail path
        return frames, (t0, time.time())

    processed = 0
    compute_until = 0.0             # wall time the last compute ended
    try:
        while True:
            try:
                if single:
                    try:
                        ins[0].read_with(_run_in_window)
                    except ChannelClosed as e:
                        raise _ReaderDead(e)   # peer died: terminal
                    processed += 1
                    continue
                frames, (r0, r1) = _next_round()
                stats["recv_s"] += r1 - r0
                if compute_until > r0:
                    # the part of this receive that hid under the
                    # previous item's compute — the overlap win itself
                    stats["overlapped_recv_s"] += \
                        min(r1, compute_until) - r0
                if any(k == STOP for k, _ in frames):
                    raise _Stop()
                err_frame = next(
                    (p for k, p in frames if k == ERROR), None)
                value = None
                c0 = c1 = r1
                if err_frame is None:
                    args = list(template)
                    for pos, (_, payload) in zip(chan_pos, frames):
                        args[pos] = loads_oob(payload)
                    c0 = time.time()
                    try:
                        value = _stage_to_host(method(*args))
                    except BaseException as e:  # noqa: BLE001
                        try:
                            err_frame = dumps_oob(e)
                        except Exception:   # unpicklable payload
                            err_frame = dumps_oob(RuntimeError(
                                f"{type(e).__name__}: {e}"))
                    c1 = time.time()
                    stats["compute_s"] += c1 - c0
                    compute_until = c1
                out_frame = None      # pre-encoded downstream payload
                if coll is not None:
                    kind = ERROR if err_frame is not None else DATA
                    kind, frame = coll.round(kind, value, err_frame)
                    if kind == ERROR:
                        err_frame = frame
                    else:
                        out_frame, err_frame = frame, None
                if len(items) < _MAX_TIMED_ITEMS:
                    items.append({"recv": (r0, r1), "compute": (c0, c1)})
                # no enabled() pre-check: record_exec gates itself, and
                # the task-events flag must reach dag rows even when
                # span tracing is off (state.list_tasks)
                tracing.record_exec("", "dag",
                                    f"{spec['method']}:recv", r0, r1)
                tracing.record_exec("", "dag",
                                    f"{spec['method']}", c0, c1,
                                    error=err_frame is not None)
                if err_frame is not None:
                    for out in outs:
                        out.write(err_frame, ERROR)
                else:
                    ser = out_frame if out_frame is not None \
                        else serialize(value)
                    for out in outs:
                        out.write(ser, DATA)
                    processed += 1
            except _Stop:
                for out in outs:
                    out.write(b"", STOP)
                break
            except _ReaderDead as e:
                # TERMINAL: the reader exited, no further round will
                # arrive — resuming the loop would block on an empty
                # queue forever and pin the executor thread through
                # teardown. Ship the error and leave.
                try:
                    frame = dumps_oob(e.cause)
                except Exception:
                    frame = dumps_oob(RuntimeError(
                        f"{type(e.cause).__name__}: {e.cause}"))
                for out in outs:
                    try:
                        out.write(frame, ERROR, timeout=5.0)
                        # STOP too: downstream stages must terminate —
                        # shm rings carry no peer-death signal, so an
                        # un-terminated consumer would block forever.
                        out.write(b"", STOP, timeout=5.0)
                    except Exception:  # noqa: BLE001 — tearing down
                        pass
                break
            except _Upstream as e:   # zero-copy path only
                for out in outs:
                    out.write(e.frame, ERROR)
            except BaseException as e:  # noqa: BLE001 — ship downstream
                try:
                    frame = dumps_oob(e)
                except Exception:  # unpicklable exception payload
                    frame = dumps_oob(RuntimeError(
                        f"{type(e).__name__}: {e}"))
                for out in outs:
                    out.write(frame, ERROR)
    finally:
        coll_chans = coll.channels() if coll is not None else []
        for ch in ins + outs + coll_chans:
            ch.close()
            if getattr(ch, "_lazy_owner", False):
                ch.unlink()   # consumer created this same-node segment
    return {"method": spec["method"], "processed": processed,
            "timing": stats, "items": items}


# --- device transport helpers --------------------------------------------
#
# The reference's pipeline-stage loop (pipe_exec_loop, driven by
# train/pipeline.py) ships its activations and gradients through these;
# the loop itself waits for ROADMAP Queue 1 item 13, the helpers are the
# device transport's and ported with it.

class _UnwalkableTree(TypeError):
    """A container whose ctor isn't shape-compatible (defaultdict, a
    NamedTuple with a custom __new__, ...) sits in the tree — strict
    walkers raise this so EFFECTFUL mappings can undo their side
    effects instead of silently dropping a mapped subtree."""


def _map_tree_leaves(fn, value, strict: bool = False):
    """ONE container walk (dict / NamedTuple / list-tuple) shared by
    the device-transport helpers below — the same shapes _stage_tree
    handles, with the same exotic-constructor guard: non-strict
    walkers pass an unmappable container through unmapped (the
    _stage_tree behavior); strict walkers raise _UnwalkableTree.
    (_stage_tree deliberately keeps its own walk: it preserves
    container IDENTITY when no leaf changed — a no-copy optimization
    the always-rebuilding mappers here don't want to inherit.)"""
    def bail(v):
        if strict:
            raise _UnwalkableTree(type(v).__name__)
        return v
    if isinstance(value, dict):
        out = {k: _map_tree_leaves(fn, v, strict)
               for k, v in value.items()}
        if type(value) is dict:
            return out
        try:
            return type(value)(out)
        except _UnwalkableTree:
            raise
        except TypeError:       # defaultdict etc.
            return bail(value)
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        try:
            return type(value)(*(_map_tree_leaves(fn, v, strict)
                                 for v in value))
        except _UnwalkableTree:
            raise
        except TypeError:       # NamedTuple-like with custom __new__
            return bail(value)
    if isinstance(value, (list, tuple)):
        try:
            return type(value)(_map_tree_leaves(fn, v, strict)
                               for v in value)
        except _UnwalkableTree:
            raise
        except TypeError:       # exotic sequence ctor
            return bail(value)
    return fn(value)



def _ship_device_tree(value, ttl_s: Optional[float]):
    """torch tensor leaves -> parked TensorRefs (runtime/device_store.py):
    only the handle rides the channel; the tensor moves at most once,
    on the consumer's resolve. Returns (wrapped, tensor_bytes). An
    unwalkable container anywhere in the tree falls the WHOLE payload
    back to host staging, freeing any already-parked refs — a partial
    ship would strand parked tensors with no consumer to free them."""
    tensor_t = _tensor_type()
    if tensor_t is None:
        return value, 0
    from ray_tpu_torch.runtime.device_store import _store
    nbytes = [0]
    shipped: list = []

    def ship(v):
        if isinstance(v, tensor_t):
            ref = _store().put(v, ttl_s=ttl_s)
            shipped.append(ref)
            nbytes[0] += v.element_size() * v.numel()
            return ref
        return v
    try:
        return _map_tree_leaves(ship, value, strict=True), nbytes[0]
    except _UnwalkableTree:
        for ref in shipped:
            ref.free()
        return value, 0


def _resolve_device_tree(value, device=None):
    """TensorRef leaves -> materialized tensors on ``device`` (None: the
    parked tensor itself in its own process, else the card; the
    reference's ``sharding`` has no counterpart yet), freeing each ref
    the moment it resolves: the consumer owns the tensor's lifetime, so
    the producer's store holds only what is in flight."""
    from ray_tpu_torch.runtime.device_store import TensorRef

    def resolve(v):
        if isinstance(v, TensorRef):
            try:
                return v.resolve(device)
            finally:
                v.free()
        return v
    return _map_tree_leaves(resolve, value)
