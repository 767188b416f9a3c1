"""Device meshes and the train step: ``MeshSpec``, ``make_mesh``,
``DeviceMesh``; ``TrainState``, ``default_optimizer``, ``make_train_step``
and ``make_eval_step``; ``state_to_numpy``, ``numpy_template`` and
``state_from_numpy`` carry a train state to and from the numpy pytrees
the checkpoint plane (``train/ckptio.py``) saves.

Counterpart of ``ray_tpu/parallel/mesh.py``. There, DP/FSDP/TP/CP are
axes of one ``jax.sharding.Mesh`` and GSPMD inserts the collectives into
one program that one controller process runs over the mesh's devices.
Here one process drives every shard too: a ``DeviceMesh`` names the
axes over a grid of torch devices (repeats allowed: ``("cuda:0",) * 4``
on a one-card machine, ``("cpu",) * 8`` in the CPU tests stand in for
the JAX tests' virtual devices, with the real per-shard shapes), and its
collectives move each group's parts to the group's first device with
``.to()``, combine them there in shard order and move the result back
(serving's ``parallel/tp.py`` ``TensorMesh`` is the one-axis case):
deterministic, no ``torch.distributed``, no NCCL. The model (a family's
``llama.MeshModule``: ``models/llama.py`` ``MeshLlama``, ``models/moe.py``
``MeshMoE``) holds one leaf parameter per block, and the step's autograd
graph spans every shard, so the collectives' backward passes are
autograd's own.

The step: loss, its gradients by autograd (attention's through the
hand-written K1/K2/K3 kernels on the card, once per shard), the global
norm of the unclipped gradients, and optax's ``chain(clip_by_global_norm,
adamw(warmup_cosine_decay))`` written out, over the parameters (every
logical element once: the blocks partition each tensor). The step
updates the model and the optimizer's moments in place (JAX returns new
arrays; here that would double the memory of every parameter).
``ShardAdamW`` is the same optimizer in optax's shape over one flat
shard, for the ZeRO-1 ``train.ShardedOptimizer`` of data-parallel
worker groups.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama import MeshAxes, MeshModule


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        # the name tensors report, so shards compare equal to them
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis sizes; -1 means "absorb all remaining devices" (at most one)."""
    data: int = 1
    fsdp: int = -1
    tensor: int = 1
    context: int = 1
    expert: int = 1
    axes: MeshAxes = MeshAxes()

    def resolve(self, n_devices: int) -> dict:
        sizes = {self.axes.data: self.data, self.axes.fsdp: self.fsdp,
                 self.axes.tensor: self.tensor,
                 self.axes.context: self.context,
                 self.axes.expert: self.expert}
        unknown = [a for a, s in sizes.items() if s == -1]
        known = 1
        for s in sizes.values():
            if s != -1:
                known *= s
        if len(unknown) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if unknown:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {known}")
            sizes[unknown[0]] = n_devices // known
        total = 1
        for s in sizes.values():
            total *= s
        if total != n_devices:
            raise ValueError(f"mesh {sizes} != {n_devices} devices")
        return sizes


class DeviceMesh:
    """Torch devices on a grid with named axes, in the JAX axis order.

    ``devices`` is the flat shard order (C order over the grid, as
    ``jax.sharding.Mesh.devices.flat``); ``shape[axis]`` is an axis' size,
    as ``mesh.shape[axis]`` reads on a JAX mesh. A collective along one
    axis runs once per group of shards that differ only in that axis'
    coordinate: it takes one part per mesh shard, in shard order, and
    gives one result per shard, on the shard's device."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        flat = [_device(d) for d in grid.flat]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.devices: Tuple[torch.device, ...] = tuple(flat)
        self._groups: dict = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {[str(d) for d in self.devices]})"

    def coords(self, j: int) -> dict:
        """Shard j's coordinate on each axis."""
        at = np.unravel_index(j, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, at)}

    def index(self, coords: dict) -> int:
        """The shard at ``coords`` (an axis left out is at 0)."""
        return int(np.ravel_multi_index(
            tuple(coords.get(a, 0) for a in self.axis_names),
            tuple(self.shape.values())))

    def groups(self, axis: str) -> List[List[int]]:
        """The shards that differ only in ``axis``, a list per group
        ordered along it, groups in the order of their first shard."""
        if axis not in self._groups:
            out: dict = {}
            for j in range(self.size):
                co = self.coords(j)
                co.pop(axis)
                out.setdefault(tuple(co.values()), []).append(j)
            self._groups[axis] = list(out.values())
        return self._groups[axis]

    def _combine(self, parts: Sequence[torch.Tensor], axis: str,
                 fn: Callable[[List[torch.Tensor]], torch.Tensor]) -> dict:
        """{each group's first shard: ``fn`` of the group's parts, moved
        to that shard's device, in axis order}; a group of one part is
        that part."""
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} parts for a mesh of "
                             f"{self.size} shards")
        out = {}
        for g in self.groups(axis):
            dst = self.devices[g[0]]
            ps = [parts[j].to(dst) for j in g]
            out[g[0]] = ps[0] if len(ps) == 1 else fn(ps)
        return out

    def _spread(self, axis: str, done: dict,
                pick: Callable[[torch.Tensor, int], torch.Tensor]
                ) -> List[torch.Tensor]:
        out: List[Optional[torch.Tensor]] = [None] * self.size
        for g in self.groups(axis):
            for i, j in enumerate(g):
                out[j] = pick(done[g[0]], i).to(self.devices[j])
        return out

    def all_reduce(self, parts: Sequence[torch.Tensor],
                   axis: str) -> List[torch.Tensor]:
        """The sum of each group's parts, added in axis order."""
        def add(ps):
            total = ps[0]
            for p in ps[1:]:
                total = total + p
            return total
        return self._spread(axis, self._combine(parts, axis, add),
                            lambda x, i: x)

    def all_gather(self, parts: Sequence[torch.Tensor], axis: str,
                   dim: int) -> List[torch.Tensor]:
        """Each group's parts concatenated along ``dim`` in axis order."""
        return self._spread(
            axis, self._combine(parts, axis, lambda ps: torch.cat(ps, dim)),
            lambda x, i: x)

    def reduce_scatter(self, parts: Sequence[torch.Tensor], axis: str,
                       dim: int) -> List[torch.Tensor]:
        """Each group's sum, cut in equal blocks along ``dim``: the shard
        at position i along ``axis`` gets block i."""
        n = self.shape[axis]
        summed = dict(zip(range(self.size), self.all_reduce(parts, axis)))
        return self._spread(axis, summed,
                            lambda x, i: x.chunk(n, dim)[i])

    def ring_shift(self, parts: Sequence[torch.Tensor],
                   axis: str) -> List[torch.Tensor]:
        """The ring's step (JAX's ``ppermute`` with perm ``i -> i + 1``):
        the shard at position i along ``axis`` gets position i - 1's part
        (position 0 the last one's)."""
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} parts for a mesh of "
                             f"{self.size} shards")
        out: List[Optional[torch.Tensor]] = [None] * self.size
        for g in self.groups(axis):
            for i, j in enumerate(g):
                out[j] = parts[g[i - 1]].to(self.devices[j])
        return out


def make_mesh(spec: MeshSpec = MeshSpec(),
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A ``DeviceMesh`` over ``devices`` (default: every visible CUDA
    device; raises without one) with ``spec``'s axis sizes, in the JAX
    axis order (data, fsdp, tensor, context, expert). A device may repeat.
    The expert axis splits the MoE family's experts (``models/moe.py``);
    the rest of that family, and a Llama, are replicated over it."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    sizes = spec.resolve(len(devices))
    grid = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        grid[i] = d
    return DeviceMesh(grid.reshape(tuple(sizes.values())), tuple(sizes))


@dataclasses.dataclass
class TrainState:
    """The model (its parameters, updated in place), the optimizer state
    and the number of steps taken."""
    params: nn.Module
    opt_state: Any
    step: int


# AdamW's constants in the JAX package's default_optimizer
B1, B2, EPS = 0.9, 0.95, 1e-8


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element of every tensor, f32 0-d,
    on the first tensor's device (each tensor's norm is moved there)."""
    dev = tensors[0].device
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32).to(dev)
             for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass
class AdamWState:
    mu: List[torch.Tensor]      # first moments, in each parameter's dtype
    nu: List[torch.Tensor]      # second moments, likewise
    count: int = 0              # updates applied


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``chain(clip_by_global_norm(grad_clip), adamw(schedule,
    b1=B1, b2=B2, eps=EPS, eps_root=0, weight_decay))`` with the
    warmup-cosine schedule, step for step:

    - clip: when the gradients' global norm ``g`` is ``>= grad_clip``,
      each becomes ``g_i / g * grad_clip`` (no epsilon, unlike
      ``torch.nn.utils.clip_grad_norm_``);
    - the moments live in each parameter's dtype (optax's
      ``mu_dtype=None``), bias-corrected by ``1 - b^count``;
    - decay applies to every parameter, embeddings and norms included;
    - the update at count ``c`` (from 0) is scaled by the schedule at
      ``c``: the first update has lr = 0 when there is a warmup.
    """
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0

    def schedule(self, count: int) -> float:
        """``optax.warmup_cosine_decay_schedule(0, learning_rate, warmup,
        max(total, warmup + 1))`` at ``count``: linear from 0 over the
        warmup, then cosine down to 0 at the end (counted from 0, warmup
        included)."""
        peak, warmup = self.learning_rate, self.warmup_steps
        if count < warmup:
            return (0.0 - peak) * (1.0 - count / warmup) + peak
        span = max(self.total_steps, warmup + 1) - warmup
        t = min(count - warmup, span)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / span))

    def init(self, params: List[torch.Tensor]) -> AdamWState:
        return AdamWState([torch.zeros_like(p) for p in params],
                          [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, state: AdamWState, params: List[torch.Tensor],
               grads: List[torch.Tensor], grad_norm: torch.Tensor) -> None:
        """One step in place: ``grads`` (scaled in place by the clip),
        the moments and ``params``. ``grad_norm`` is ``global_norm(grads)``
        of the unclipped gradients; each tensor is updated on its own
        device."""
        lr = self.schedule(state.count)
        state.count += 1
        bc1 = 1.0 - B1 ** state.count
        bc2 = 1.0 - B2 ** state.count
        clip = torch.where(grad_norm < self.grad_clip,
                           torch.ones_like(grad_norm),
                           self.grad_clip / grad_norm)
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            g.mul_(clip.to(g.device, g.dtype))
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            upd = (mu / bc1) / ((nu / bc2).sqrt() + EPS)
            upd.add_(p, alpha=self.weight_decay)
            p.add_(upd, alpha=-lr)


def default_optimizer(learning_rate: float = 3e-4,
                      weight_decay: float = 0.1,
                      warmup_steps: int = 100,
                      total_steps: int = 10_000,
                      grad_clip: float = 1.0) -> AdamW:
    """The JAX package's default: global-norm clipping, then AdamW (b1
    0.9, b2 0.95, eps 1e-8) on a linear-warmup cosine schedule from 0 to
    ``learning_rate`` and back to 0 at ``max(total_steps, warmup+1)``."""
    return AdamW(learning_rate=learning_rate, weight_decay=weight_decay,
                 warmup_steps=warmup_steps, total_steps=total_steps,
                 grad_clip=grad_clip)


class ShardAdamWState(NamedTuple):
    """The state of ``ShardAdamW`` over one flat shard: f32 moments (on
    the optimizer's device; numpy after a checkpoint restore, moved back
    at the next update) and the updates applied so far."""
    mu: Any
    nu: Any
    count: int


@dataclasses.dataclass(frozen=True)
class ShardAdamW:
    """``AdamW`` in optax's shape, for ``train/zero.py``
    ``ShardedOptimizer``: ``init(flat_shard)`` and ``update(g, state,
    shard) -> (updates, state)`` over one flat f32 shard of the
    parameter space, computed on ``device`` (None: the CUDA card), with
    ``adamw``'s schedule, decay and clip, step for step as
    ``AdamW.update`` applies them to whole tensors (the moments here are
    f32: the shard's dtype). The clip needs the norm of the WHOLE
    gradient, which no shard holds: ``clip_by_global_norm`` tells
    ``ShardedOptimizer`` to sum the ranks' ``sq_norm`` over its ring and
    pass the norm as ``update(..., grad_norm=)``. Host arrays in give
    host arrays out; the moments stay on ``device`` (a shard of a 1.5
    B-parameter model holds 3 GB of each), and an update returns new
    moment tensors, as optax's does, leaving the given state as it was
    (a ZeRO step retried after a lost peer, and the peer mirror of the
    last completed step, read it)."""
    adamw: AdamW = AdamW()
    device: Any = None

    @property
    def clip_by_global_norm(self) -> float:
        return self.adamw.grad_clip

    def _put(self, x) -> torch.Tensor:
        dev = resolve_device(self.device)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return torch.as_tensor(x).to(dev, torch.float32)

    def init(self, flat_shard) -> ShardAdamWState:
        n = int(np.asarray(flat_shard).size) \
            if not isinstance(flat_shard, torch.Tensor) \
            else flat_shard.numel()
        dev = resolve_device(self.device)
        return ShardAdamWState(torch.zeros(n, device=dev),
                               torch.zeros(n, device=dev), 0)

    def sq_norm(self, g) -> float:
        """This shard's squared L2 norm, for the global clip."""
        return float(torch.linalg.vector_norm(self._put(g))) ** 2

    @torch.no_grad()
    def update(self, g, state: ShardAdamWState, shard,
               grad_norm: Optional[float] = None):
        host = isinstance(g, np.ndarray)
        opt = self.adamw
        gt, pt = self._put(g), self._put(shard)
        mu, nu = self._put(state.mu), self._put(state.nu)
        count = int(state.count)
        lr = opt.schedule(count)
        count += 1
        bc1 = 1.0 - B1 ** count
        bc2 = 1.0 - B2 ** count
        if grad_norm is not None and grad_norm >= opt.grad_clip:
            gt.mul_(opt.grad_clip / grad_norm)
        # new moment tensors, the old ones untouched: a step that fails
        # after this point (a peer lost in the allgather) is retried
        # from the state it was given, and the last completed step's
        # state stays whole while the next one runs. gt goes before the
        # temporaries come, so the card holds no more at once than an
        # in-place update would.
        mu = torch.mul(mu, B1).add_(gt, alpha=1.0 - B1)
        nu = torch.mul(nu, B2).addcmul_(gt, gt, value=1.0 - B2)
        del gt
        den = torch.div(nu, bc2).sqrt_().add_(EPS)
        upd = torch.div(mu, bc1).div_(den)
        del den
        upd.add_(pt, alpha=opt.weight_decay)
        upd.mul_(-lr)
        return (upd.cpu().numpy() if host else upd), \
            ShardAdamWState(mu, nu, count)


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _single(mesh: Optional[DeviceMesh], device) -> Optional[torch.device]:
    """The device of a step without shards: ``device`` without a mesh,
    the one device of a one-device mesh; None for a mesh of several."""
    if mesh is None:
        return device
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (make_mesh), not "
                        f"{type(mesh).__name__}")
    if device is not None:
        raise ValueError("pass either a mesh or a device")
    return mesh.devices[0] if mesh.size == 1 else None


def make_train_step(cfg, mesh: Optional[DeviceMesh] = None,
                    axes: MeshAxes = MeshAxes(), *,
                    device: Optional[torch.device] = None,
                    optimizer: Optional[AdamW] = None,
                    loss_fn: Optional[Callable] = None,
                    model=llama):
    """Returns ``(init_fn, step_fn)``:

    - ``init_fn(generator=None, params=None) -> TrainState``: a trainable
      model from ``model.init_params(generator, cfg, device)``, or the
      given ``params`` module (e.g. from ``bridge.params_from_numpy(...,
      trainable=True)``), with fresh optimizer state. ``device=None`` is
      the CUDA device, and raises when there is none. Over a ``mesh`` of
      several devices the model is drawn on the mesh's first device (or
      taken as given: the family's whole model, or its ``MeshModule`` on
      this mesh) and sharded with ``model.shard_params_for_training``.
    - ``step_fn(state, batch) -> (state, metrics)``: loss and gradients
      of ``loss_fn(model, batch)`` (default ``model.loss_fn`` with
      ``cfg``, and ``mesh`` and ``axes``), then one optimizer update, all
      in place; ``metrics`` has ``loss`` and ``grad_norm`` (the unclipped
      gradients' global norm), both f32 0-d tensors on the (first)
      device, and ``step``. Over a mesh, ``batch`` holds the whole arrays
      (host arrays or tensors), split over (data, fsdp) x context here,
      or per column every shard's block (``llama.shard_batch``,
      ``iter_device_batches(sharding=mesh)``).

    A one-device mesh is the single-device step on its device.
    ``model`` is a module exposing ``init_params`` and ``loss_fn`` (and
    ``shard_params_for_training`` over a mesh), as
    ``ray_tpu_torch.models.llama`` (the default) and
    ``ray_tpu_torch.models.moe`` do."""
    one = _single(mesh, device)
    sharded = mesh is not None and one is None
    opt = optimizer if optimizer is not None else default_optimizer()
    if loss_fn is not None:
        _loss = loss_fn
    elif sharded:
        def _loss(m, b):
            return model.loss_fn(m, b, cfg, mesh, axes)
    else:
        def _loss(m, b):
            return model.loss_fn(m, b, cfg)

    def init_fn(generator: Optional[torch.Generator] = None,
                params: Optional[nn.Module] = None) -> TrainState:
        dev = resolve_device(mesh.devices[0] if sharded else one)
        if params is None:
            if generator is None:
                raise ValueError("init_fn needs a generator or params")
            params = model.init_params(generator, cfg, dev,
                                       trainable=not sharded)
        elif isinstance(params, MeshModule):
            if params.mesh is not mesh or not all(
                    p.requires_grad for p in params.parameters()):
                raise ValueError("params must be trainable and sharded "
                                 "over this mesh")
        elif not sharded and any(p.device != dev or not p.requires_grad
                                 for p in params.parameters()):
            raise ValueError(f"params must be trainable and on {dev}")
        if sharded and not isinstance(params, MeshModule):
            params = model.shard_params_for_training(params, mesh, axes)
        return TrainState(params, opt.init(list(params.parameters())), 0)

    def step_fn(state: TrainState, batch: dict):
        net = state.params
        params = list(net.parameters())
        for p in params:
            p.grad = None
        loss = _loss(net, batch if sharded
                     else _to_device(batch, params[0].device))
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        gnorm = global_norm(grads)
        opt.update(state.opt_state, params, grads, gnorm)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm,
                       "step": state.step}

    return init_fn, step_fn


def make_eval_step(cfg, mesh: Optional[DeviceMesh] = None,
                   axes: MeshAxes = MeshAxes(), *, model=llama):
    """``eval_fn(params, batch) -> loss`` without gradients (over a mesh
    of several devices, ``params`` is the ``MeshModule`` of a train state
    and ``batch`` as ``step_fn`` takes it)."""
    sharded = mesh is not None and _single(mesh, None) is None

    @torch.no_grad()
    def eval_fn(params: nn.Module, batch: dict) -> torch.Tensor:
        if sharded:
            return model.loss_fn(params, batch, cfg, mesh, axes)
        dev = next(params.parameters()).device
        return model.loss_fn(params, _to_device(batch, dev), cfg)

    return eval_fn


# --- to and from numpy, for train/ckptio ---------------------------------


def _host(t: torch.Tensor) -> np.ndarray:
    """A moment on the host in its own dtype: bf16 as its raw bits in
    ``uint16`` (numpy has no bf16), the format of ``llm/pd.py`` and
    ``runtime/device_store.py``."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _entries(net: nn.Module) -> list:
    """Per logical tensor: (name, whole shape, [(index into
    ``net.parameters()``, the part's index in the tensor)]). A whole
    model's parameters are whole; a ``MeshModule``'s blocks make up each
    tensor of the model it was cut from, under its names."""
    if isinstance(net, MeshModule):
        return net.entries()
    return [(n, tuple(p.shape), [(k, ())])
            for k, (n, p) in enumerate(net.named_parameters())]


def _numpy_tree(state: TrainState, tree) -> Tuple[dict, dict]:
    """``tree(values, kind)`` -> {name: host array} over the logical
    tensors, for the parameters (kind "param") and each moment."""
    opt = state.opt_state
    return (tree(list(state.params.parameters()), "param"),
            {"mu": tree(opt.mu, "moment"), "nu": tree(opt.nu, "moment"),
             "count": np.asarray(opt.count, np.int64),
             "step": np.asarray(state.step, np.int64)})


@torch.no_grad()
def state_to_numpy(state: TrainState) -> Tuple[dict, dict]:
    """``(params, opt)``: a train state as the numpy pytrees that
    ``ckptio.AsyncCheckpointer.save`` takes. ``params`` maps each
    parameter's name to its value widened to float32, exactly (the JAX
    package's checkpoint widens bf16 parameters into its float32 flat
    space too: ``ckptio._wire_of``); ``opt`` holds AdamW's moments in
    their own dtype (bf16 as ``uint16`` bits), the update count and
    ``state.step``. Each array is a host copy. A mesh state gives the
    whole (logical) tensors under the single-device names, as the JAX
    package's checkpoints hold global arrays, so it restores into a
    single-device state and back."""
    entries = _entries(state.params)

    def tree(values, kind):
        conv = ((lambda t: t.detach().float().cpu().numpy())
                if kind == "param" else _host)
        out = {}
        for name, shape, parts in entries:
            if len(parts) == 1 and parts[0][1] == ():
                out[name] = conv(values[parts[0][0]])
                continue
            for i, (k, idx) in enumerate(parts):
                a = conv(values[k])
                if i == 0:
                    out[name] = np.empty(shape, a.dtype)
                out[name][idx] = a
        return out

    return _numpy_tree(state, tree)


def numpy_template(state: TrainState) -> Tuple[dict, dict]:
    """The layout ``state_to_numpy`` gives, as uninitialised arrays: the
    ``params_template``/``state_template`` of ``ckptio.restore``,
    without copying the state off the card."""
    entries = _entries(state.params)

    def dtype(t: torch.Tensor, kind: str):
        if kind == "param":
            return np.float32
        return (np.uint16 if t.dtype == torch.bfloat16
                else torch.empty(0, dtype=t.dtype).numpy().dtype)

    def tree(values, kind):
        return {name: np.empty(shape, dtype(values[parts[0][0]], kind))
                for name, shape, parts in entries}

    return _numpy_tree(state, tree)


@torch.no_grad()
def state_from_numpy(state: TrainState, params: dict,
                     opt: dict) -> TrainState:
    """Load ``(params, opt)`` (as ``state_to_numpy`` or
    ``ckptio.restore`` give them) into ``state`` in place: each
    parameter rounded back to its dtype (exact for a bf16 value widened
    to float32), each moment from its bits, the count and the step; a
    mesh state takes each block from the whole tensor. Returns
    ``state``."""
    def put(t: torch.Tensor, a: np.ndarray) -> None:
        a = np.ascontiguousarray(a)
        if t.dtype == torch.bfloat16 and a.dtype == np.uint16:
            src = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            src = torch.from_numpy(a)
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint array {tuple(src.shape)} does "
                             f"not fit {tuple(t.shape)}")
        t.copy_(src)

    entries = _entries(state.params)
    names = [name for name, _, _ in entries]
    if set(names) != set(params):
        raise ValueError(f"checkpoint parameters {sorted(params)} are "
                         f"not the model's {sorted(names)}")
    tensors = list(state.params.parameters())
    mus, nus = state.opt_state.mu, state.opt_state.nu
    for name, _, parts in entries:
        for k, idx in parts:
            put(tensors[k], params[name][idx])
            put(mus[k], opt["mu"][name][idx])
            put(nus[k], opt["nu"][name][idx])
    state.opt_state.count = int(opt["count"])
    state.step = int(opt["step"])
    return state
