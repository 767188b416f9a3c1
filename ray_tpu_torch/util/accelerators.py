"""Accelerator plugin registry: pluggable detection per vendor.

The generic seam behind node resource/label auto-detection (reference:
python/ray/_private/accelerators/__init__.py — an AcceleratorManager ABC
with TPU/NVIDIA/AMD/... implementations selected at node start). TPU is
the first-class citizen here (util/tpu.py does the heavy lifting);
NVIDIA GPUs are detected so mixed clusters schedule correctly, and new
vendors register a plugin instead of patching node startup.

    from ray_tpu_torch.util.accelerators import register, AcceleratorPlugin
    class MyNPU(AcceleratorPlugin):
        resource_name = "NPU"
        def count(self): ...
    register(MyNPU())
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional


class AcceleratorPlugin:
    """Implement `count()` (visible devices on this host); optionally
    `labels()` (topology metadata riding node labels)."""

    resource_name: str = "ACC"

    def count(self) -> int:
        raise NotImplementedError

    def labels(self) -> Dict[str, str]:
        return {}


class TPUPlugin(AcceleratorPlugin):
    """Wraps util/tpu.py (chips via env / /dev/accel* / vfio; topology
    labels; MEGASCALE env handled by the train layer)."""

    resource_name = "TPU"

    def count(self) -> int:
        from ray_tpu_torch.util import tpu
        return tpu.num_tpu_chips_on_host()

    def labels(self) -> Dict[str, str]:
        from ray_tpu_torch.util import tpu
        return tpu.node_tpu_labels()


class NvidiaGPUPlugin(AcceleratorPlugin):
    """NVIDIA detection without vendor libraries: honors
    CUDA_VISIBLE_DEVICES when set (reference:
    _private/accelerators/nvidia_gpu.py), else counts /dev/nvidia[0-9]*
    or /proc/driver/nvidia/gpus entries."""

    resource_name = "GPU"

    def count(self) -> int:
        vis = os.environ.get("CUDA_VISIBLE_DEVICES")
        if vis is not None:
            # CUDA semantics: entries from the first invalid/empty one
            # onward are masked — "0,-1", "0,1," expose 1 and 2 devices
            n = 0
            for seg in vis.strip().split(","):
                seg = seg.strip()
                if not seg or seg == "-1" or \
                        not (seg.isdigit() or seg.startswith("GPU-")
                             or seg.startswith("MIG-")):
                    break
                n += 1
            return n
        n = len(glob.glob("/dev/nvidia[0-9]*"))
        if n:
            return n
        try:
            return len(os.listdir("/proc/driver/nvidia/gpus"))
        except OSError:
            return 0

    def labels(self) -> Dict[str, str]:
        name = None
        try:
            gpus = sorted(os.listdir("/proc/driver/nvidia/gpus"))
            if gpus:
                with open(f"/proc/driver/nvidia/gpus/{gpus[0]}"
                          f"/information") as f:
                    for line in f:
                        if line.startswith("Model:"):
                            name = line.split(":", 1)[1].strip()
                            break
        except OSError:
            pass
        return {"gpu_model": name} if name else {}


_PLUGINS: List[AcceleratorPlugin] = [TPUPlugin(), NvidiaGPUPlugin()]


def register(plugin: AcceleratorPlugin) -> None:
    """Add a vendor plugin (replaces an existing one with the same
    resource_name)."""
    global _PLUGINS
    _PLUGINS = [p for p in _PLUGINS
                if p.resource_name != plugin.resource_name]
    _PLUGINS.append(plugin)


def plugins() -> List[AcceleratorPlugin]:
    return list(_PLUGINS)


def detect_resources() -> Dict[str, float]:
    """{resource_name: count} for every plugin seeing devices here. A
    plugin that RAISES is reported loudly (not swallowed): a typo'd
    TPU_CHIPS_PER_HOST must not silently advertise zero chips and
    leave jobs pending unschedulable."""
    import sys
    out: Dict[str, float] = {}
    for p in _PLUGINS:
        try:
            n = p.count()
        except Exception as e:  # noqa: BLE001 — keep other plugins alive
            print(f"[ray_tpu_torch] accelerator plugin {p.resource_name} "
                  f"detection failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            n = 0
        if n:
            out[p.resource_name] = float(n)
    return out


# Dense peak TFLOPs per device (bf16 matmul) — the single source of
# truth for the goodput ledger's train_mfu gauge (util/goodput.py). Keys are substrings
# matched case-insensitively against the device's name: jax's
# device_kind on a TPU (e.g. "TPU v5 lite" -> v5, handled by the
# explicit v5e/v5p entries first), torch.cuda.get_device_name on a card
# ("NVIDIA H100 80GB HBM3": the H100 SXM's dense bf16 rate).
PEAK_TFLOPS = {"v5e": 197.0, "v5p": 459.0, "v6": 918.0, "v4": 275.0,
               "h100": 989.0}

_WARNED_KINDS: set = set()


def peak_tflops(kind: str) -> float:
    """Peak dense TFLOPs for a device kind (substring match). An
    unknown kind WARNS (once per kind) instead of silently assuming
    v5e's 197 — a wrong denominator makes every MFU number quietly
    wrong, which is worse than a noisy default."""
    import sys
    low = (kind or "").lower()
    for k, v in PEAK_TFLOPS.items():
        if k in low:
            return v
    if low not in _WARNED_KINDS:
        _WARNED_KINDS.add(low)
        print(f"[ray_tpu_torch] unknown device kind {kind!r} for peak "
              f"TFLOPs — assuming a TPU v5e's 197.0; MFU numbers "
              f"derived from it are suspect (add the device, a TPU "
              f"generation or a card, to "
              f"util/accelerators.PEAK_TFLOPS)", file=sys.stderr)
    return 197.0


def detect_labels() -> Dict[str, str]:
    import sys
    out: Dict[str, str] = {}
    for p in _PLUGINS:
        try:
            out.update(p.labels())
        except Exception as e:  # noqa: BLE001
            print(f"[ray_tpu_torch] accelerator plugin {p.resource_name} "
                  f"labels failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
    return out
