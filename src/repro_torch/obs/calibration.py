"""Persistent calibration store: measured profiles + residual feedback.
The port's copy of the JAX package's `obs.calibration`; only the backend
fingerprint differs (torch and CUDA versions, the card's name), so one
file holds both packages' entries and neither reads the other's.

`CALIBRATION.json` (override: `REPRO_CALIBRATION_PATH`, validated at read
time like `REPRO_PALLAS_INTERPRET` — a bad value raises instead of
silently writing somewhere else) caches `PrimitiveProfile.measure()`
results **across processes**, keyed by a backend fingerprint (platform +
device kind + torch and CUDA versions): the second process on the same backend loads
the stored constants instead of re-running the microbenchmarks, and a
different backend never reads another's numbers. The same entry holds the
per-(operator, strategy) measured/modeled residual EWMAs
(`obs.residuals.ResidualStore`) that each traced run feeds back, so the
engine's cost model sharpens run over run instead of being calibrated
once and trusted forever (ROADMAP: "stop treating calibration as
one-shot").

Schema (one entry per backend fingerprint)::

    {
      "<fingerprint>": {
        "profiles": {"<n>": {"seq_bw": ..., "sort_pass_bw": ...,
                              "partition_pass_bw": ...,
                              "unclustered_penalty": ...,
                              "clustered_penalty": ...}},
        "residuals": {"<op>/<strategy>": {"ewma": r, "count": k,
                                           "last": r}}
      }
    }

`engine.physical.calibrated_profile()` consults this store before
re-measuring.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re

from ..core.planner import PrimitiveProfile

from .residuals import ResidualStore

DEFAULT_PATH = "CALIBRATION.json"

_PROFILE_FIELDS = tuple(f.name for f in dataclasses.fields(PrimitiveProfile))


def calibration_path() -> str:
    """Resolved store path. `REPRO_CALIBRATION_PATH` overrides the default
    `CALIBRATION.json` (cwd); the override is validated per call, never
    frozen at import: an empty value, an existing directory, or a parent
    directory that does not exist raises ValueError naming the variable —
    a typo'd path must not silently split the calibration history."""
    env = os.environ.get("REPRO_CALIBRATION_PATH")
    if env is None:
        return DEFAULT_PATH
    path = env.strip()
    if not path:
        raise ValueError(
            "REPRO_CALIBRATION_PATH is set but empty; unset it to use "
            f"./{DEFAULT_PATH} or point it at a writable JSON file path")
    if os.path.isdir(path):
        raise ValueError(
            f"REPRO_CALIBRATION_PATH={env!r} is a directory; it must name "
            "the JSON file itself (e.g. /path/to/CALIBRATION.json)")
    parent = os.path.dirname(os.path.abspath(path))
    if not os.path.isdir(parent):
        raise ValueError(
            f"REPRO_CALIBRATION_PATH={env!r} points into a directory that "
            f"does not exist ({parent}); create it first")
    return path


def backend_fingerprint(device=None) -> str:
    """Stable id of the measuring backend: platform, device kind, and torch
    and CUDA versions. `device` (default: the card when there is one, else
    the CPU) names the device whose profile is meant. Profiles measured
    under one fingerprint are never served to another — a CPU's rates
    must not price a plan on the card."""
    import platform

    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        backend = f"cuda{torch.version.cuda}"
        kind = torch.cuda.get_device_name(device)
    else:
        backend = kind = device.type
    kind = re.sub(r"[^A-Za-z0-9_.-]+", "_", str(kind)).strip("_") or backend
    return f"{platform.system().lower()}-{backend}-{kind}-torch{torch.__version__}"


class CalibrationStore:
    """Read-modify-write view of the calibration JSON file. Load/save are
    whole-file (the store is a few KiB of constants); every read path
    tolerates a missing or corrupt file by starting empty — calibration is
    an accelerant, never a correctness dependency."""

    def __init__(self, path: str | None = None):
        self.path = path if path is not None else calibration_path()
        self.data: dict = {}
        self.load()

    def load(self) -> None:
        try:
            with open(self.path) as f:
                data = json.load(f)
            self.data = data if isinstance(data, dict) else {}
        except (OSError, ValueError):
            self.data = {}

    def save(self) -> None:
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.data, f, indent=2, sort_keys=True)
        os.replace(tmp, self.path)  # atomic: readers never see a torn file

    def _entry(self, fingerprint: str) -> dict:
        return self.data.setdefault(fingerprint,
                                    {"profiles": {}, "residuals": {}})

    # -- measured profiles --------------------------------------------------
    def get_profile(self, fingerprint: str,
                    n: int) -> PrimitiveProfile | None:
        """The stored profile measured at calibration size `n`, or None.
        Entries missing any model constant are ignored (schema drift must
        fall back to re-measuring, not to half a profile)."""
        raw = self.data.get(fingerprint, {}).get("profiles", {}).get(str(n))
        if not isinstance(raw, dict):
            return None
        try:
            kw = {k: float(raw[k]) for k in _PROFILE_FIELDS}
        except (KeyError, TypeError, ValueError):
            return None
        return PrimitiveProfile(**kw)

    def put_profile(self, fingerprint: str, n: int,
                    profile: PrimitiveProfile) -> None:
        self._entry(fingerprint)["profiles"][str(n)] = {
            k: float(getattr(profile, k)) for k in _PROFILE_FIELDS}

    # -- residual feedback --------------------------------------------------
    def residual_store(self, fingerprint: str) -> ResidualStore:
        raw = self.data.get(fingerprint, {}).get("residuals", {})
        return ResidualStore.from_dict(raw if isinstance(raw, dict) else {})

    def put_residuals(self, fingerprint: str, store: ResidualStore) -> None:
        self._entry(fingerprint)["residuals"] = store.as_dict()


def load_residuals(path: str | None = None,
                   fingerprint: str | None = None) -> ResidualStore:
    """The current backend's residual store (empty when nothing was ever
    recorded, or the store path is invalid — advisory data only)."""
    try:
        store = CalibrationStore(path)
        return store.residual_store(fingerprint or backend_fingerprint())
    except ValueError:
        return ResidualStore()
