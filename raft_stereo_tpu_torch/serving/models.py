"""Model registry: versioned weights in the shared artifact store, the JAX
package's ``serving/models.py`` on the port.

A **ModelStore** keeps versioned checkpoints in the artifact store's
``models/<name>/<version>`` namespace (beside persist.py's kernel
libraries and the ``sessions/`` handoff namespace), and a
**RegisteredModel** is one loaded version the engine's registry threads
through dispatch, program keys, prewarm and telemetry.

Store layout: one directory per version, written by the atomic machinery
the port's training checkpoints use (training/checkpoint.py):
``config.json`` + ``weights.pt`` (the port's state dict) + a per-file
SHA-256 ``MANIFEST`` sealed by the ``COMMIT`` marker, staged in a
same-filesystem tmp dir and ``os.replace``d into place.  A version is
IMMUTABLE once published (re-publishing an existing version is a typed
error unless forced); a flipped byte anywhere in the blob fails
``verify`` instead of serving garbage weights.

    models/
      kitti/
        v1/   config.json  weights.pt  MANIFEST  COMMIT
        v2/   ...

A version the JAX package published holds an orbax ``state/`` directory
instead of ``weights.pt``; loading it raises ``ModelStoreError`` naming
``tools/jax_checkpoint_to_torch.py``, which converts such a checkpoint
(reading it needs JAX, which the port does not import).

Identity rules the rest of the subsystem builds on:

* A model COORDINATE is ``name@version`` (``parse_model_spec``).  Names
  and versions are path-safe tokens — the store never joins untrusted
  path segments.
* The engine's implicit constructor model has NO coordinate (``None``):
  every key, metric, and wire field it touches is byte-identical to the
  pre-registry build.  The model coordinate only exists where a named
  model does.
* ``ModelUnknown`` is the typed admission error (HTTP 404
  ``model_unknown``) — same contract as the tier ladder's unknown-tier
  400, one level up.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

log = logging.getLogger(__name__)

MODELS_SUBDIR = "models"

# The directory a JAX-published version keeps its orbax state in.
JAX_STATE_DIR = "state"

# Path-safe model name / version tokens: the store builds filesystem
# paths from them, so they must never carry separators or traversal.
_TOKEN_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


class ModelUnknown(KeyError):
    """A request named a model this engine does not serve (HTTP 404,
    ``{"error": "model_unknown"}``) — the model-layer sibling of the
    tier ladder's unknown-tier ValueError."""

    def __init__(self, model: str, known: List[str]):
        super().__init__(
            f"unknown model {model!r}: this engine serves "
            f"{sorted(known) or '(no registered models)'}")
        self.model = model
        self.known = sorted(known)

    def __str__(self) -> str:  # KeyError quotes its arg; keep it readable
        return self.args[0]


class ModelStoreError(RuntimeError):
    """Typed store failure: missing/torn version, hash mismatch, an
    immutability violation (publishing over an existing version), or a
    version in the JAX package's orbax format."""


class ModelVersionExists(ModelStoreError):
    """Publish refused: the version already exists and is complete —
    versions are immutable; publish a NEW version instead."""


def _check_token(kind: str, value: str) -> str:
    if not isinstance(value, str) or not _TOKEN_RE.match(value):
        raise ValueError(
            f"model {kind} {value!r} must match {_TOKEN_RE.pattern} "
            f"(path-safe token; the store builds paths from it)")
    return value


def parse_model_spec(spec: str) -> Tuple[str, Optional[str]]:
    """``"name@version"`` -> (name, version); bare ``"name"`` -> (name,
    None) — the caller resolves None to the store's latest version."""
    if "@" in spec:
        name, _, version = spec.partition("@")
        return _check_token("name", name), _check_token("version", version)
    return _check_token("name", spec), None


def model_coord(name: str, version: str) -> str:
    """The canonical ``name@version`` coordinate every key and metric
    label carries."""
    return f"{name}@{version}"


@dataclasses.dataclass
class RegisteredModel:
    """One loaded model version: the identity coordinate plus the host
    state dict the engine builds its per-worker/per-tier models from.
    The version carries its OWN ``RaftStereoConfig``, so a registered
    model may differ from the process default in any architecture
    knob."""

    name: str
    version: str
    config: Any                      # RaftStereoConfig
    variables: Any                   # the state dict, on the CPU
    metadata: Optional[Dict[str, Any]] = None

    @property
    def coord(self) -> str:
        return model_coord(self.name, self.version)


def _is_jax_version(path: str) -> bool:
    """A version directory in the JAX package's format: an orbax
    ``state/`` and no ``weights.pt``."""
    from raft_stereo_tpu_torch.io.jax_weights import WEIGHTS_FILE
    return (os.path.isdir(os.path.join(path, JAX_STATE_DIR))
            and not os.path.exists(os.path.join(path, WEIGHTS_FILE)))


class ModelStore:
    """The ``models/<name>/<version>`` namespace of the shared artifact
    store.  Thread-safe; every version directory is written atomically
    by training/checkpoint.py's stage-manifest-commit-rename machinery
    and verified (deep SHA-256) before its weights are ever served."""

    def __init__(self, root: str, subdir: str = MODELS_SUBDIR):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.dir = os.path.join(self.root, subdir)
        self._lock = threading.Lock()

    def _version_dir(self, name: str, version: str) -> str:
        _check_token("name", name)
        _check_token("version", version)
        return os.path.join(self.dir, name, version)

    # -------------------------------------------------------------- publish
    def publish(self, name: str, version: str, config,
                variables: Mapping[str, Any],
                metadata: Optional[Dict[str, Any]] = None,
                force: bool = False) -> str:
        """Snapshot ``(config, state dict)`` into the store as
        ``name@version``, atomically (staged tmp dir, per-file SHA-256
        MANIFEST, COMMIT seal, os.replace).  ``variables`` is the port's
        state dict (a ``RAFTStereo`` lends its own).  Returns the version
        directory.  Raises ``ModelVersionExists`` when the version is
        already complete (immutable) unless ``force=True`` — force exists
        for re-publishing after a torn write, not for mutating a served
        version."""
        from raft_stereo_tpu_torch.training.checkpoint import (
            is_valid_checkpoint, save_weights)

        path = self._version_dir(name, version)
        with self._lock:
            if not force and is_valid_checkpoint(path):
                raise ModelVersionExists(
                    f"model {model_coord(name, version)} already exists "
                    f"in {self.dir} — versions are immutable; publish a "
                    f"new version (or force=True to repair a torn one)")
        state = (variables.state_dict() if hasattr(variables, "state_dict")
                 else variables)
        meta = dict(metadata or {})
        meta.setdefault("name", name)
        meta.setdefault("version", version)
        save_weights(path, config, state, runtime_state=meta)
        log.info("published model %s -> %s",
                 model_coord(name, version), path)
        return path

    # ---------------------------------------------------------------- load
    def load(self, name: str, version: str,
             deep: bool = True) -> RegisteredModel:
        """Load one version as a ``RegisteredModel``; ``deep`` (default)
        verifies every file against the sealed SHA-256 manifest first —
        a corrupt blob raises typed instead of serving wrong weights."""
        from raft_stereo_tpu_torch.training.checkpoint import (
            is_valid_checkpoint, load_runtime_state, load_weights,
            verify_manifest)

        path = self._version_dir(name, version)
        if _is_jax_version(path):
            raise ModelStoreError(
                f"model {model_coord(name, version)} under {self.dir} "
                f"holds the JAX package's orbax state/, which the port "
                f"cannot read: convert it with "
                f"tools/jax_checkpoint_to_torch.py and publish the result "
                f"as a new version")
        if not is_valid_checkpoint(path):
            raise ModelStoreError(
                f"model {model_coord(name, version)} is missing or torn "
                f"under {self.dir}")
        if deep:
            ok, reason = verify_manifest(path)
            if not ok:
                raise ModelStoreError(
                    f"model {model_coord(name, version)} failed deep "
                    f"validation: {reason}")
        cfg, state = load_weights(path)
        return RegisteredModel(name=name, version=version, config=cfg,
                               variables=state,
                               metadata=load_runtime_state(path))

    def resolve(self, spec: str, deep: bool = True) -> RegisteredModel:
        """Load a ``name@version`` spec; a bare ``name`` resolves to the
        newest complete version."""
        name, version = parse_model_spec(spec)
        if version is None:
            version = self.latest_version(name)
            if version is None:
                raise ModelStoreError(
                    f"model {name!r} has no complete versions under "
                    f"{self.dir}")
        return self.load(name, version, deep=deep)

    # -------------------------------------------------------------- queries
    def has(self, name: str, version: str) -> bool:
        from raft_stereo_tpu_torch.training.checkpoint import (
            is_valid_checkpoint)
        try:
            return is_valid_checkpoint(self._version_dir(name, version))
        except ValueError:
            return False

    def versions(self, name: str) -> List[str]:
        """Complete versions of one model, sorted (publication order is
        not recoverable from names alone; callers wanting the newest use
        ``latest_version`` — mtime-ranked)."""
        from raft_stereo_tpu_torch.training.checkpoint import (
            is_valid_checkpoint)
        root = os.path.join(self.dir, _check_token("name", name))
        try:
            entries = sorted(os.listdir(root))
        except OSError:
            return []
        return [e for e in entries
                if ".tmp-" not in e and ".old-" not in e
                and is_valid_checkpoint(os.path.join(root, e))]

    def latest_version(self, name: str) -> Optional[str]:
        root = os.path.join(self.dir, _check_token("name", name))
        best, best_mtime = None, -1.0
        for v in self.versions(name):
            mtime = os.path.getmtime(os.path.join(root, v))
            if mtime > best_mtime:
                best, best_mtime = v, mtime
        return best

    def list_models(self) -> Dict[str, List[str]]:
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            return {}
        out = {}
        for n in names:
            if not _TOKEN_RE.match(n):
                continue
            vs = self.versions(n)
            if vs:
                out[n] = vs
        return out

    def verify(self, name: str, version: str) -> Tuple[bool, str]:
        """Deep integrity verdict of one version (``(ok, reason)``) —
        the operator's pre-rollout check."""
        from raft_stereo_tpu_torch.training.checkpoint import verify_manifest
        return verify_manifest(self._version_dir(name, version))
