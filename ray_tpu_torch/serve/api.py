"""Serve public API: @deployment, bind, run, shutdown, handles.

The port's copy of ``ray_tpu/serve/api.py``, over the port's runtime.

Reference surface: python/ray/serve/api.py (:409 @serve.deployment,
:821 serve.run), serve/handle.py. An Application is a bound deployment
graph — ``Model.bind(Preprocessor.bind())`` composes deployments; child
applications in init args become DeploymentHandles inside the replica.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

from ray_tpu_torch import api as core_api
from ray_tpu_torch.serve.handle import (CONTROLLER_NAME, SERVE_NAMESPACE,
                                  DeploymentHandle, _HandleRef)

DEFAULT_HTTP_PORT = 8000

_state = {"proxy": None, "proxy_addr": None}


@dataclass
class Application:
    deployment: "Deployment"
    init_args: tuple = ()
    init_kwargs: dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.deployment.name


class Deployment:
    def __init__(self, cls_or_fn: Callable, name: str, *,
                 num_replicas: Any = 1,
                 autoscaling_config: Optional[dict] = None,
                 max_ongoing_requests: int = 16,
                 route_prefix: Optional[str] = None,
                 user_config: Optional[dict] = None,
                 ray_actor_options: Optional[dict] = None,
                 gang: Any = None):
        if gang and autoscaling_config:
            raise ValueError(
                "gang deployments are fixed-size: gang= and "
                "autoscaling_config= are mutually exclusive")
        self._target = cls_or_fn
        self.name = name
        self.num_replicas = num_replicas
        self.autoscaling_config = autoscaling_config
        self.max_ongoing_requests = max_ongoing_requests
        self.route_prefix = route_prefix
        self.user_config = user_config
        self.ray_actor_options = ray_actor_options
        self.gang = "STRICT_SPREAD" if gang is True else gang

    def options(self, **kw) -> "Deployment":
        merged = dict(
            num_replicas=self.num_replicas,
            autoscaling_config=self.autoscaling_config,
            max_ongoing_requests=self.max_ongoing_requests,
            route_prefix=self.route_prefix,
            user_config=self.user_config,
            ray_actor_options=self.ray_actor_options,
            gang=self.gang,
        )
        name = kw.pop("name", self.name)
        merged.update(kw)
        return Deployment(self._target, name, **merged)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def _cls_payload(self) -> bytes:
        target = self._target
        if isinstance(target, type):
            return cloudpickle.dumps(target, protocol=5)

        # Function deployment: wrap into a single-method class.
        fn = target

        class _FnDeployment:
            def __call__(self, *a, **kw):
                return fn(*a, **kw)

        _FnDeployment.__name__ = getattr(fn, "__name__", "fn_deployment")
        return cloudpickle.dumps(_FnDeployment, protocol=5)


def deployment(_target: Optional[Callable] = None, *,
               name: Optional[str] = None,
               num_replicas: Any = 1,
               autoscaling_config: Optional[dict] = None,
               max_ongoing_requests: int = 16,
               route_prefix: Optional[str] = None,
               user_config: Optional[dict] = None,
               ray_actor_options: Optional[dict] = None,
               gang: Any = None):
    """``@serve.deployment`` / ``@serve.deployment(num_replicas=...)``.

    ``num_replicas`` may be an int or ``"auto"`` (autoscaling with
    defaults); explicit ``autoscaling_config`` wins.

    ``gang=True`` (or a PG strategy string) co-schedules the replicas as
    ONE placement group — num_replicas bundles of the replica's
    resources, STRICT_SPREAD by default, all-or-nothing (reference:
    serve/gang.py gang deployments for TP x PP engines; here the gang is
    the slice-granular unit, e.g. one replica per TPU host).
    """
    def wrap(target):
        nonlocal autoscaling_config, num_replicas
        if num_replicas == "auto" and autoscaling_config is None:
            autoscaling_config = {"min_replicas": 1, "max_replicas": 8,
                                  "target_ongoing_requests": 2}
        return Deployment(
            target, name or getattr(target, "__name__", "deployment"),
            num_replicas=1 if autoscaling_config else num_replicas,
            autoscaling_config=autoscaling_config,
            max_ongoing_requests=max_ongoing_requests,
            route_prefix=route_prefix,
            user_config=user_config,
            ray_actor_options=ray_actor_options,
            gang=gang)

    if _target is not None:
        return wrap(_target)
    return wrap


# -- controller / proxy plumbing --------------------------------------------

def _get_or_create_controller():
    try:
        return core_api.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
    except ValueError:
        pass
    from ray_tpu_torch.serve.controller import ServeController
    try:
        # max_restarts: a crashed controller comes back and re-adopts its
        # persisted app specs (reference: serve controller checkpoints to
        # the GCS KV and recovers)
        h = core_api.remote(ServeController).options(
            name=CONTROLLER_NAME, namespace=SERVE_NAMESPACE,
            lifetime="detached", max_concurrency=32,
            max_restarts=100).remote()
    except Exception:
        h = core_api.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
    core_api.get(h.start.remote(), timeout=30)
    return h


def _collect_specs(app: Application, specs: Dict[str, dict]):
    """Walk the bind graph depth-first; nested Applications become
    _HandleRef placeholders resolved inside replicas."""
    def conv(v):
        if isinstance(v, Application):
            _collect_specs(v, specs)
            return _HandleRef(v.name)
        return v

    d = app.deployment
    init_args = tuple(conv(a) for a in app.init_args)
    init_kwargs = {k: conv(v) for k, v in app.init_kwargs.items()}
    if d.name in specs:
        return
    specs[d.name] = {
        "name": d.name,
        "cls_payload": d._cls_payload(),
        "init_args": init_args,
        "init_kwargs": init_kwargs,
        "num_replicas": d.num_replicas,
        "autoscaling_config": d.autoscaling_config,
        "max_ongoing_requests": d.max_ongoing_requests,
        "route_prefix": d.route_prefix,
        "user_config": d.user_config,
        "actor_options": d.ray_actor_options,
        "gang": getattr(d, "gang", None),
    }


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/",
        http_port: Optional[int] = None,
        ready_timeout_s: float = 120.0,
        _blocking_ready: bool = True) -> DeploymentHandle:
    """Deploy an application; returns a handle to the ingress deployment
    (reference: serve/api.py:821)."""
    core_api._require_init()
    controller = _get_or_create_controller()

    specs: Dict[str, dict] = {}
    _collect_specs(app, specs)
    # The ingress deployment gets the app-level route_prefix unless it set
    # its own.
    ingress = specs[app.name]
    if ingress.get("route_prefix") is None and route_prefix is not None:
        ingress["route_prefix"] = route_prefix

    core_api.get(controller.deploy_app.remote(name, list(specs.values())),
                 timeout=60)
    if _blocking_ready:
        r = core_api.get(
            controller.wait_ready.remote(name, ready_timeout_s),
            timeout=ready_timeout_s + 30)
        if not r.get("ok"):
            raise RuntimeError(r.get("error", "serve app failed to start"))

    if any(s.get("route_prefix") for s in specs.values()):
        _ensure_proxy(http_port or DEFAULT_HTTP_PORT)
    return DeploymentHandle(app.name)


def _ensure_proxy(port: int):
    if _state["proxy_addr"] is not None:
        return _state["proxy_addr"]
    from ray_tpu_torch.serve.proxy import HTTPProxy
    try:
        h = core_api.get_actor("SERVE_PROXY", namespace=SERVE_NAMESPACE)
        addr = core_api.get(h.metrics.remote(), timeout=10)  # liveness
        _state["proxy"] = h
        kv = _kv_proxy_addr()
        _state["proxy_addr"] = kv or {"host": "127.0.0.1", "port": port}
        return _state["proxy_addr"]
    except ValueError:
        pass
    h = core_api.remote(HTTPProxy).options(
        name="SERVE_PROXY", namespace=SERVE_NAMESPACE,
        lifetime="detached", max_concurrency=64).remote()
    addr = core_api.get(h.start.remote("127.0.0.1", port), timeout=30)
    _state["proxy"] = h
    _state["proxy_addr"] = addr
    _put_kv_proxy_addr(addr)
    return addr


def _kv_proxy_addr():
    import json
    ctx = core_api._g.ctx
    raw = core_api._run(ctx.pool.call(ctx.head_addr, "kv_get",
                                      key="__serve_proxy_addr"))
    return json.loads(raw) if raw else None


def _put_kv_proxy_addr(addr):
    import json
    ctx = core_api._g.ctx
    core_api._run(ctx.pool.call(ctx.head_addr, "kv_put",
                                key="__serve_proxy_addr",
                                value=json.dumps(addr).encode()))


def proxy_address() -> Optional[dict]:
    """{host, port} of the HTTP ingress (None before the first run())."""
    return _state["proxy_addr"] or _kv_proxy_addr()


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name)


def status() -> dict:
    controller = core_api.get_actor(CONTROLLER_NAME,
                                    namespace=SERVE_NAMESPACE)
    return core_api.get(controller.status.remote(), timeout=30)


def delete(app_name: str = "default"):
    controller = core_api.get_actor(CONTROLLER_NAME,
                                    namespace=SERVE_NAMESPACE)
    core_api.get(controller.delete_app.remote(app_name), timeout=30)


def shutdown():
    """Tear down all serve state (apps, replicas, proxy, controller)."""
    try:
        controller = core_api.get_actor(CONTROLLER_NAME,
                                        namespace=SERVE_NAMESPACE)
    except ValueError:
        return
    import time
    try:
        apps = core_api.get(controller.list_apps.remote(), timeout=10)
        for name in apps:
            core_api.get(controller.delete_app.remote(name), timeout=30)
        # Wait for the reconcile loop to reap every replica.
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if not core_api.get(controller.status.remote(), timeout=30):
                break
            time.sleep(0.2)
    except Exception:
        pass
    for name in ("SERVE_PROXY", CONTROLLER_NAME):
        try:
            core_api.kill(core_api.get_actor(name,
                                             namespace=SERVE_NAMESPACE))
        except Exception:
            pass
    _state["proxy"] = None
    _state["proxy_addr"] = None
