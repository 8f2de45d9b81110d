"""Calibration plane: measured-vs-modeled provenance and the live roofline
(the port of ``windflow_tpu/monitoring/calibration.py``).

* **Provenance vocabulary.**  Every surfaced quantity that is not a
  direct measurement carries one of four tags: ``measured`` (a clock or
  byte counter on the live path), ``modeled`` (a constant or a
  structural estimate), ``calibrated(<age>)`` (a modeled constant
  replaced by a probe measurement, with its age) or ``interpret`` (a
  run of a kernel's plain version, never a speed figure).

* **Calibration store.**  ``python -m
  windflow_tpu_torch.monitoring.calibrate`` (``monitoring/calibrate.py``)
  probes the card and writes a versioned ``calibration.json`` keyed by
  device kind (``torch.cuda.get_device_name()``).  ``Config.calibration``
  / ``WF_TPU_CALIBRATION`` names the file; every read site goes through
  :func:`constant`, which returns ``(value, provenance)``: the
  calibrated value while the store is fresh and was recorded on this
  device kind, the modeled default (with a one-time warning) once it is
  stale past ``WF_TPU_CALIBRATION_TTL_S`` or from another device.
  ``WF_TPU_CALIBRATION=0`` is the kill switch.  The file keeps the JAX
  package's schema, ``jax_version`` field included (its loader requires
  it), so ``tools/wf_calibrate.py --check`` validates the port's file
  unchanged; the port writes ``"torch <version>"`` there and adds
  ``torch_version`` beside it.

* **Live roofline.**  :class:`RooflineLedger` turns the replicas'
  cumulative input counters into per-hop tuples/s at cadence (two
  integer reads an operator a tick, nothing per batch), joins them with
  the sweep ledger's bytes a tuple and the calibrated memory bandwidth
  into ``stats()["Roofline"]``, and latches the advisory
  ``ROOFLINE_DEGRADED`` verdict when the dominant hop's rate collapses
  against its own trailing baseline.  The sweep ledger's bytes are the
  step's tensor bytes (``"tensor-bytes"``): an estimate from the tensors'
  shapes, so their tag in the vocabulary is ``modeled`` and the hop
  carries the source as ``bytes_per_tuple_source``.

The modeled defaults are NVIDIA H100 SXM figures: 3.35 TB/s of HBM3,
PCIe Gen5 x16 (64 GB/s a direction) host to device, NVLink 4 (450 GB/s
a direction) between cards.  The module is pure stdlib apart from the
device-kind probe, which imports torch lazily.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import warnings
from collections import deque
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# provenance vocabulary
# ---------------------------------------------------------------------------

#: a direct measurement on the live path (clocks, byte counters)
MEASURED = "measured"
#: a constant or a structural estimate (the sweep ledger's tensor bytes)
MODELED = "modeled"
#: a run of a kernel's plain version: a correctness vehicle
INTERPRET = "interpret"
#: prefix of the aged calibrated tag (see :func:`calibrated_tag`)
CALIBRATED_PREFIX = "calibrated("

#: schema tag of calibration.json (the JAX package's, so its tools read it)
SCHEMA = "wf-calibration/1"

#: freshness TTL in seconds (default 7 days): past it the store degrades
#: to the modeled defaults with a one-time warning
TTL_S = float(os.environ.get("WF_TPU_CALIBRATION_TTL_S", str(7 * 86400)))

#: the constants a store may carry, with their modeled defaults (the JAX
#: package's six keys: ``tools/wf_calibrate.py --check`` rejects others)
MODELED_DEFAULTS = {
    # bandwidth between cards: NVLink 4, per direction
    "ici_bytes_per_sec": 450e9,
    # host-to-device staging bandwidth: PCIe Gen5 x16, per direction
    "h2d_tunnel_bytes_per_sec": float(os.environ.get(
        "WF_TPU_TUNNEL_BYTES_PER_SEC", str(64e9))),
    # memory bandwidth the roofline ceiling divides by: H100 SXM HBM3
    "hbm_bytes_per_sec": float(os.environ.get(
        "WF_TPU_HBM_BYTES_PER_SEC", str(3.35e12))),
    # host cost of one small kernel launch through torch (µs)
    "dispatch_overhead_usec": 5.0,
    # one sampled device wait: an event record and synchronize (µs)
    "sampled_sync_usec": 10.0,
    # one CB FFAT step at the bench shape (µs); 0 = not modeled
    "kernel_step_usec": 0.0,
}

#: keys whose probe needs several devices: absent from a one-card store
#: by design, not corruption
MESH_ONLY_KEYS = ("ici_bytes_per_sec",)


def calibrated_tag(age_s: float) -> str:
    """The aged provenance tag: ``calibrated(3h)`` / ``calibrated(2d)``."""
    age_s = max(0.0, float(age_s))
    if age_s < 120:
        human = f"{int(age_s)}s"
    elif age_s < 2 * 3600:
        human = f"{int(age_s // 60)}m"
    elif age_s < 2 * 86400:
        human = f"{int(age_s // 3600)}h"
    else:
        human = f"{int(age_s // 86400)}d"
    return f"{CALIBRATED_PREFIX}{human})"


def is_calibrated(tag: str) -> bool:
    return isinstance(tag, str) and tag.startswith(CALIBRATED_PREFIX)


def legal_provenance(tag) -> bool:
    """True for any tag of the four-value vocabulary."""
    return tag in (MEASURED, MODELED, INTERPRET) or is_calibrated(tag)


# ---------------------------------------------------------------------------
# the calibration store
# ---------------------------------------------------------------------------

class CalibrationError(ValueError):
    """calibration.json failed validation: a corrupt store must never
    read as calibrated truth."""


class CalibrationStore:
    """One validated calibration.json: measured constants keyed by the
    device kind they were probed on."""

    __slots__ = ("path", "recorded_at", "device_kind", "backend",
                 "jax_version", "torch_version", "constants", "probes")

    def __init__(self, doc: dict, path: Optional[str] = None) -> None:
        if not isinstance(doc, dict):
            raise CalibrationError("calibration document is not an object")
        if doc.get("schema") != SCHEMA:
            raise CalibrationError(
                f"schema {doc.get('schema')!r} != {SCHEMA!r}")
        rec = doc.get("recorded_at")
        if not isinstance(rec, (int, float)) or not math.isfinite(rec) \
                or rec <= 0:
            raise CalibrationError(f"bad recorded_at {rec!r}")
        kind = doc.get("device_kind")
        jv = doc.get("jax_version")
        if not isinstance(kind, str) or not kind:
            raise CalibrationError(f"bad device_kind {kind!r}")
        if not isinstance(jv, str) or not jv:
            raise CalibrationError(f"bad jax_version {jv!r}")
        consts = doc.get("constants")
        if not isinstance(consts, dict) or not consts:
            raise CalibrationError("constants missing or empty")
        for k, v in consts.items():
            if k not in MODELED_DEFAULTS:
                raise CalibrationError(f"unknown constant {k!r}")
            if not isinstance(v, (int, float)) or not math.isfinite(v) \
                    or v < 0:
                raise CalibrationError(f"constant {k!r} not a finite "
                                       f"non-negative number: {v!r}")
        self.path = path
        self.recorded_at = float(rec)
        self.device_kind = kind
        self.backend = doc.get("backend")
        self.jax_version = jv
        tv = doc.get("torch_version")
        self.torch_version = tv if isinstance(tv, str) else None
        self.constants = {k: float(v) for k, v in consts.items()}
        self.probes = doc.get("probes") if isinstance(doc.get("probes"),
                                                      dict) else {}

    def age_s(self, now: Optional[float] = None) -> float:
        return max(0.0, (now if now is not None else time.time())
                   - self.recorded_at)

    def fresh(self, now: Optional[float] = None) -> bool:
        return self.age_s(now) <= TTL_S

    def to_json(self) -> dict:
        out = {
            "schema": SCHEMA,
            "recorded_at": self.recorded_at,
            "device_kind": self.device_kind,
            "backend": self.backend,
            "jax_version": self.jax_version,
            "constants": dict(self.constants),
            "probes": dict(self.probes),
        }
        if self.torch_version is not None:
            out["torch_version"] = self.torch_version
        return out


def load(path: str) -> CalibrationStore:
    """Read and validate one calibration.json; raises
    :class:`CalibrationError` on any corruption."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise CalibrationError(f"unreadable: {e}") from e
    except ValueError as e:
        raise CalibrationError(f"not JSON: {e}") from e
    return CalibrationStore(doc, path=path)


# -- the process-wide store ---------------------------------------------------

_lock = threading.Lock()
_store: Optional[CalibrationStore] = None
_store_resolved = False
_warned: set = set()          # one-time warning keys


def _warn_once(key: str, msg: str) -> None:
    with _lock:
        if key in _warned:
            return
        _warned.add(key)
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


def killed() -> bool:
    """The kill switch: ``WF_TPU_CALIBRATION=0`` (or ``off``) keeps every
    read site on its modeled default."""
    return os.environ.get("WF_TPU_CALIBRATION", "").lower() in ("0", "off",
                                                                "false")


def default_store() -> Optional[CalibrationStore]:
    """The process-wide store: installed by :func:`set_default_store`
    (``PipeGraph._build`` on ``Config.calibration``) or resolved lazily
    from ``WF_TPU_CALIBRATION`` (a path).  None = uncalibrated."""
    global _store, _store_resolved
    if _store is not None or _store_resolved:
        return _store
    with _lock:
        if _store is not None or _store_resolved:
            return _store
        _store_resolved = True
    env = os.environ.get("WF_TPU_CALIBRATION", "")
    if not env or killed():
        return None
    try:
        store = load(env)
    except CalibrationError as e:
        _warn_once(f"load:{env}",
                   f"WF_TPU_CALIBRATION={env!r} failed to load ({e}) — "
                   "running uncalibrated, every modeled constant keeps "
                   "its default")
        return None
    with _lock:
        _store = store
    return _store


def set_default_store(store: Optional[CalibrationStore]) -> None:
    """Install (or clear, re-resolving from the environment) the
    process-wide store."""
    global _store, _store_resolved
    with _lock:
        _store = store
        _store_resolved = store is not None
        if store is None:
            _warned.clear()


_device_kind_cache: Optional[str] = None


def live_device_kind() -> Optional[str]:
    """The device kind this process runs on: the first visible card's
    ``torch.cuda.get_device_name()``, or ``"cpu"`` without one (cached;
    None when torch cannot answer, which lets the store's kind gate
    pass)."""
    global _device_kind_cache
    if _device_kind_cache is not None:
        return _device_kind_cache
    try:
        import torch
        _device_kind_cache = (torch.cuda.get_device_name()
                              if torch.cuda.is_available() else "cpu")
    except Exception:  # lint: broad-except-ok (a broken CUDA setup
        # degrades the kind gate to "unknown", never a stats read)
        return None
    return _device_kind_cache


def constant(key: str, default: Optional[float] = None,
             now: Optional[float] = None) -> Tuple[float, str]:
    """THE modeled-constant read path: ``(value, provenance)``.  The
    calibrated value and its aged tag while the store is fresh, carries
    ``key`` and was recorded on this device kind; the modeled default
    and ``modeled`` otherwise (a stale or foreign store warns once).
    Called at stats cadence, never per batch."""
    if default is None:
        default = MODELED_DEFAULTS[key]
    store = default_store()
    if store is None or key not in store.constants:
        return float(default), MODELED
    kind = live_device_kind()
    if kind is not None and store.device_kind != kind:
        _warn_once(f"kind:{store.path}",
                   f"calibration {store.path or '<installed>'} was "
                   f"recorded on device kind {store.device_kind!r} but "
                   f"this process runs {kind!r} — ignoring it, every "
                   "modeled constant keeps its default")
        return float(default), MODELED
    if not store.fresh(now):
        _warn_once(f"stale:{store.path}",
                   f"calibration {store.path or '<installed>'} is "
                   f"{store.age_s(now) / 86400:.1f} days old (TTL "
                   f"{TTL_S / 86400:.1f}d) — degrading to the modeled "
                   "defaults; re-run python -m "
                   "windflow_tpu_torch.monitoring.calibrate")
        return float(default), MODELED
    return store.constants[key], calibrated_tag(store.age_s(now))


def provenance_summary(now: Optional[float] = None) -> dict:
    """Where each modeled constant comes from now: the postmortem's
    ``calibration.json``, ``dump_trace`` metadata and the
    ``wf_provenance`` OpenMetrics family."""
    store = default_store()
    out = {
        "schema": SCHEMA,
        "enabled": not killed(),
        "source": getattr(store, "path", None),
        "device_kind": live_device_kind(),
    }
    if store is not None:
        out["store"] = {
            "recorded_at": store.recorded_at,
            "device_kind": store.device_kind,
            "jax_version": store.jax_version,
            "torch_version": store.torch_version,
            "age_s": round(store.age_s(now), 1),
            "fresh": store.fresh(now),
        }
    out["constants"] = {}
    for key in MODELED_DEFAULTS:
        v, prov = constant(key, now=now)
        out["constants"][key] = {"value": v, "provenance": prov}
    return out


# ---------------------------------------------------------------------------
# live roofline plane
# ---------------------------------------------------------------------------

#: the dominant hop's rate below this fraction of its trailing baseline is
#: a breach tick
DEGRADE_RATIO = float(os.environ.get("WF_TPU_ROOFLINE_DEGRADE", "0.5"))


class RooflineLedger:
    """Cadence roofline gauge over counters that already exist.

    ``tick()`` diffs each device hop's cumulative input counter against
    the previous tick into a bounded rate ring; ``section()`` joins the
    rings with the sweep ledger's bytes a tuple and the calibrated memory
    bandwidth.  The verdict machine is the SLO plane's: enter after
    ``ENTER_AFTER`` consecutive collapse ticks once ``MIN_SAMPLES`` rates
    exist, latch, clear after ``CLEAR_AFTER`` consecutive OK ticks —
    against the hop's own trailing baseline."""

    ENTER_AFTER = 2
    CLEAR_AFTER = 3
    MIN_SAMPLES = 8
    WINDOW = 64
    #: ticks closer than this are one compare (a headless run may tick
    #: every sweep)
    TICK_MIN_INTERVAL_S = 0.2

    def __init__(self, graph) -> None:
        self._graph = graph
        self._last_tick_s: Optional[float] = None
        #: op name -> bounded ring of tuples/s samples
        self._rings: Dict[str, deque] = {}
        #: op name -> (wall s, cumulative inputs) at the previous tick
        self._prev: Dict[str, tuple] = {}
        self.ticks = 0
        self.entered = 0
        self.cleared = 0
        self._breach_ticks = 0
        self._ok_ticks = 0
        self.verdict: Optional[dict] = None
        self.last_verdict: Optional[dict] = None
        self._lock = threading.Lock()

    def tick(self, now_s: Optional[float] = None) -> None:
        now_s = now_s if now_s is not None else time.monotonic()
        last = self._last_tick_s
        if last is not None and now_s - last < self.TICK_MIN_INTERVAL_S:
            return
        self._last_tick_s = now_s
        with self._lock:
            rates = {}
            for op in self._graph._operators:
                if not op.is_gpu:
                    continue
                done = sum(r.stats.inputs_received for r in op.replicas)
                prev = self._prev.get(op.name)
                self._prev[op.name] = (now_s, done)
                if prev is None:
                    continue
                dt = now_s - prev[0]
                dn = done - prev[1]
                if dt <= 0 or dn <= 0:
                    # an idle tick gives no sample: a drained graph must
                    # not latch a verdict from its own end
                    continue
                rate = dn / dt
                ring = self._rings.get(op.name)
                if ring is None:
                    ring = self._rings[op.name] = deque(maxlen=self.WINDOW)
                ring.append(rate)
                rates[op.name] = rate
            self.ticks += 1
            self._evaluate(rates)

    def _dominant(self) -> Optional[str]:
        """The hop carrying the most cumulative tuples."""
        best, best_n = None, -1
        for name, (_, n) in self._prev.items():
            if n > best_n:
                best, best_n = name, n
        return best

    def _evaluate(self, rates: Dict[str, float]) -> None:
        """The enter/latch/clear machine over the dominant hop (the
        caller holds the lock)."""
        dom = self._dominant()
        ring = self._rings.get(dom) if dom else None
        if not ring or len(ring) < self.MIN_SAMPLES or dom not in rates:
            # no fresh evidence: an active verdict stays latched
            return
        trailing = sorted(list(ring)[:-1])
        baseline = trailing[len(trailing) // 2]
        current = ring[-1]
        if baseline > 0 and current < DEGRADE_RATIO * baseline:
            self._breach_ticks += 1
            self._ok_ticks = 0
            if self.verdict is None \
                    and self._breach_ticks >= self.ENTER_AFTER:
                self.entered += 1
                self.verdict = self.last_verdict = {
                    "state": "ROOFLINE_DEGRADED",
                    "dominant_op": dom,
                    "current_tuples_per_sec": round(current, 1),
                    "baseline_tuples_per_sec": round(baseline, 1),
                    "ratio_vs_baseline": round(current / baseline, 4),
                    "degrade_ratio": DEGRADE_RATIO,
                    "entered_tick": self.ticks,
                }
        else:
            self._breach_ticks = 0
            if self.verdict is not None:
                self._ok_ticks += 1
                if self._ok_ticks >= self.CLEAR_AFTER:
                    self.cleared += 1
                    self.verdict = None
                    self._ok_ticks = 0

    def health_verdict(self) -> Optional[dict]:
        """The latest published verdict (the health plane's read)."""
        return self.verdict

    def section(self) -> dict:
        """Per-hop achieved against the roofline (stats cadence)."""
        bw, bw_prov = constant("hbm_bytes_per_sec")
        led = self._graph._ledger
        sweep_hops = {}
        if led is not None:
            try:
                sweep_hops = led.section().get("per_hop") or {}
            except Exception:  # lint: broad-except-ok (the bytes join is an
                # enrichment: a ledger fault leaves rates only)
                sweep_hops = {}
        with self._lock:
            per_hop = {}
            for name, ring in self._rings.items():
                if not ring:
                    continue
                rs = sorted(ring)
                tps = rs[len(rs) // 2]
                hop = {
                    "achieved_tuples_per_sec": round(tps, 1),
                    "samples": len(ring),
                    "tuples_per_sec_provenance": MEASURED,
                }
                sh = sweep_hops.get(name) or {}
                bpt = sh.get("steady_bytes_per_tuple") \
                    or sh.get("bytes_per_tuple")
                if bpt:
                    source = sh.get("bytes_provenance", MODELED)
                    hop["bytes_per_tuple"] = bpt
                    hop["bytes_per_tuple_provenance"] = \
                        source if legal_provenance(source) else MODELED
                    hop["bytes_per_tuple_source"] = source
                    achieved_bps = tps * float(bpt)
                    hop["achieved_bytes_per_sec"] = round(achieved_bps, 1)
                    if bw > 0:
                        hop["roofline_tuples_per_sec"] = \
                            round(bw / float(bpt), 1)
                        hop["ratio_vs_roofline"] = \
                            round(achieved_bps / bw, 6)
                per_hop[name] = hop
            return {
                "enabled": True,
                "per_hop": per_hop,
                "dominant_op": self._dominant(),
                "bandwidth_bytes_per_sec": bw,
                "bandwidth_provenance": bw_prov,
                "ticks": self.ticks,
                "entered": self.entered,
                "cleared": self.cleared,
                "verdict": self.verdict,
                "last_verdict": self.last_verdict,
                "thresholds": {
                    "degrade_ratio": DEGRADE_RATIO,
                    "enter_after": self.ENTER_AFTER,
                    "clear_after": self.CLEAR_AFTER,
                    "min_samples": self.MIN_SAMPLES,
                },
                "calibration": provenance_summary(),
            }
