"""The port's training checkpoint (the JAX package's
``training/checkpoint.py``, over the port's own files).

A checkpoint is a directory holding
* ``config.json`` and ``weights.pt``: the inference checkpoint of
  ``io/jax_weights.save_checkpoint``, so ``InferenceRunner`` and the demo
  load a trained model directly;
* ``train_config.json``: the ``TrainConfig``;
* ``train_state.pt``: torch AdamW's state dict, the update count (the
  schedule's position) and the step;
* ``runtime.json``: the loop's exact-resume sidecar (loop step, loader
  position and reshuffle salts, the numpy global RNG, the anomaly history
  and the loss EWMA), when the loop saved one;
* ``MANIFEST``: the SHA-256 of every file above, and the step;
* ``COMMIT``: written last, sealing the manifest's own hash;
* ``GOOD``: written after a restore of the checkpoint passed the
  finite-state probe (outside the manifest, by design).

Saves are atomic: everything is written into a ``<path>.tmp-<pid>``
directory beside the final name, fsynced, sealed, and moved into place
with ``os.replace`` (the parent directory fsynced after), so a crash
mid-save leaves the previous checkpoint or a ``.tmp-*`` orphan, never a
torn directory.  ``latest_checkpoint(deep=True)`` resumes from the newest
checkpoint whose manifest verifies.  Checkpoints written before the
manifest existed (no ``MANIFEST``, no ``COMMIT``) still validate and
restore.  Weights-only exports (``save_weights``) carry ``config.json``
and ``weights.pt`` with the same manifest and seal.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
from raft_stereo_tpu_torch.io.jax_weights import (CONFIG_FILE, WEIGHTS_FILE,
                                                  load_checkpoint,
                                                  save_checkpoint)
from raft_stereo_tpu_torch.training.state import (TrainState,
                                                  create_train_state)

log = logging.getLogger(__name__)

TRAIN_CONFIG_FILE = "train_config.json"
TRAIN_STATE_FILE = "train_state.pt"
COMMIT_FILE = "COMMIT"
MANIFEST_FILE = "MANIFEST"
RUNTIME_FILE = "runtime.json"
GOOD_FILE = "GOOD"


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _fsync_dir(path: str) -> None:
    """Flush a directory entry (rename durability on POSIX); a filesystem
    that cannot fsync a directory degrades to a no-op."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - non-POSIX filesystems
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def _fsync_file(path: str) -> None:
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def _write_json(path: str, payload: Any) -> None:
    with open(path, "w") as f:
        json.dump(payload, f)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _manifest_files(root: str) -> List[str]:
    """Every regular file under ``root`` but the manifest and the seal
    (relative paths, sorted): the manifest's hash domain."""
    out: List[str] = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            rel = os.path.relpath(os.path.join(dirpath, fn), root)
            if rel not in (MANIFEST_FILE, COMMIT_FILE):
                out.append(rel)
    return sorted(out)


def _save_atomic(path: str, write: Callable[[str], None],
                 step: Optional[int],
                 runtime_state: Optional[Dict[str, Any]]) -> None:
    """Stage ``write(tmp)`` (and the runtime sidecar) into
    ``<path>.tmp-<pid>``, fsync every file, hash them into ``MANIFEST``,
    seal it with ``COMMIT``, then move the directory into place."""
    path = _abs(path)
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)  # a crashed save's leftover
    os.makedirs(tmp)
    try:
        write(tmp)
        if runtime_state is not None:
            _write_json(os.path.join(tmp, RUNTIME_FILE), runtime_state)
        files = _manifest_files(tmp)
        for rel in files:
            _fsync_file(os.path.join(tmp, rel))
        manifest: Dict[str, Any] = {
            "files": {rel: _file_sha256(os.path.join(tmp, rel))
                      for rel in files}}
        commit: Dict[str, Any] = {"complete": True}
        if step is not None:
            manifest["step"] = commit["step"] = int(step)
        manifest_path = os.path.join(tmp, MANIFEST_FILE)
        _write_json(manifest_path, manifest)
        commit["manifest_sha256"] = _file_sha256(manifest_path)
        _write_json(os.path.join(tmp, COMMIT_FILE), commit)
        _fsync_dir(tmp)
        if os.path.exists(path):
            # os.replace cannot clobber a non-empty directory: retire the
            # old checkpoint first; both sides of the window are complete.
            retired = f"{path}.old-{os.getpid()}"
            shutil.rmtree(retired, ignore_errors=True)
            os.replace(path, retired)
            os.replace(tmp, path)
            shutil.rmtree(retired, ignore_errors=True)
        else:
            os.replace(tmp, path)
        _fsync_dir(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_train_checkpoint(directory: str, state: TrainState,
                          runtime_state: Optional[Dict[str, Any]] = None
                          ) -> None:
    """Save ``state`` (weights, configs, optimizer, update count, step)
    and the loop's ``runtime_state``, atomically, sealed by the
    manifest."""

    def write(tmp: str) -> None:
        save_checkpoint(tmp, state.model_cfg, state.model.state_dict())
        with open(os.path.join(tmp, TRAIN_CONFIG_FILE), "w") as f:
            json.dump(state.train_cfg.to_dict(), f, indent=2, sort_keys=True)
        torch.save({"optimizer": state.optimizer.state_dict(),
                    "count": state.update_count(),
                    "step": state.step},
                   os.path.join(tmp, TRAIN_STATE_FILE))

    _save_atomic(directory, write, state.step, runtime_state)


def save_weights(path: str, model_cfg: RaftStereoConfig,
                 state_dict: Mapping[str, torch.Tensor],
                 runtime_state: Optional[Dict[str, Any]] = None) -> None:
    """Inference export: weights and config only, sealed like a training
    checkpoint (``runtime_state``: a JSON sidecar, the model store's
    metadata)."""
    _save_atomic(path, lambda tmp: save_checkpoint(tmp, model_cfg,
                                                   state_dict), None,
                 runtime_state)


def load_weights(path: str
                 ) -> Tuple[RaftStereoConfig, Dict[str, torch.Tensor]]:
    """``(config, state_dict)`` of any checkpoint (the weights of a
    training checkpoint included), on the CPU."""
    return load_checkpoint(_abs(path))


def read_train_checkpoint(path: str) -> Tuple[RaftStereoConfig,
                                              Dict[str, torch.Tensor],
                                              Dict[str, Any]]:
    """``(model config, weights, train state)`` of a training checkpoint,
    all on the CPU: what the finite-state probe reads before the live
    state is touched."""
    model_cfg, weights = load_checkpoint(_abs(path))
    saved = torch.load(os.path.join(_abs(path), TRAIN_STATE_FILE),
                       map_location="cpu", weights_only=True)
    return model_cfg, weights, saved


def finite_state(weights: Mapping[str, torch.Tensor],
                 saved: Mapping[str, Any]) -> bool:
    """The finite-state probe: every floating tensor of the weights and
    of the optimizer's state is finite.  A checkpoint saved after
    divergence (NaN in the weights or the moments) fails it."""
    tensors = list(weights.values())
    for entry in saved["optimizer"]["state"].values():
        tensors += [v for v in entry.values()
                    if isinstance(v, torch.Tensor)]
    return all(bool(torch.isfinite(t).all()) for t in tensors
               if t.is_floating_point())


def restore_train_state(state: TrainState, weights: Mapping[str, torch.Tensor],
                        saved: Mapping[str, Any]) -> None:
    """Load a checkpoint's weights, AdamW state and update count into the
    live ``state`` in place (the rewind and the exact resume).  The
    optimizer's hyperparameters stay the live state's (its
    ``TrainConfig``, and the policy's device LR or the host schedule), as
    the JAX package's restore keeps the caller's optimizer and takes only
    its state; so a checkpoint saved with the anomaly policy on restores
    with it off, and the other way round."""
    state.model.load_state_dict(weights, strict=True)
    sd = dict(saved["optimizer"])
    sd["param_groups"] = [
        dict(g, **{k: v for k, v in live.items() if k != "params"})
        for g, live in zip(sd["param_groups"], state.optimizer.param_groups)]
    state.optimizer.load_state_dict(sd)
    # checkpoints before the update count was saved never skipped one
    state.set_count(int(saved.get("count", saved["step"])))
    state.step = int(saved["step"])


def load_train_checkpoint(directory: str, device, train_cfg: TrainConfig,
                          anomaly: bool = False) -> TrainState:
    """The state saved in ``directory``, on ``device``.  The model config
    is the checkpoint's, as in the JAX package's restore; ``train_cfg`` is
    the caller's (it builds the optimizer and the schedule), and the
    saved AdamW state and update count give their values.  ``anomaly``
    builds the state the anomaly policy steps (training/state.py)."""
    model_cfg, weights, saved = read_train_checkpoint(directory)
    state = create_train_state(model_cfg, train_cfg, device,
                               state_dict=weights, anomaly=anomaly)
    restore_train_state(state, weights, saved)
    return state


# ---------------------------------------------------------- validation
def verify_manifest(path: str) -> Tuple[bool, str]:
    """Deep integrity check: ``COMMIT`` must seal the ``MANIFEST``'s hash
    and every manifest entry must hash to its recorded SHA-256.  Returns
    ``(ok, reason)``; a checkpoint written before the manifest existed
    returns ``(True, "legacy_no_manifest")``."""
    path = _abs(path)
    manifest_path = os.path.join(path, MANIFEST_FILE)
    commit_path = os.path.join(path, COMMIT_FILE)
    if not os.path.exists(manifest_path):
        if os.path.exists(commit_path):
            try:
                with open(commit_path) as f:
                    commit = json.load(f)
            except (OSError, ValueError):
                return False, "commit_unreadable"
            if "manifest_sha256" in commit:
                return False, "manifest_missing"
        return True, "legacy_no_manifest"
    try:
        with open(commit_path) as f:
            commit = json.load(f)
        sealed = commit["manifest_sha256"]
    except (OSError, ValueError, KeyError, TypeError):
        return False, "commit_unreadable"
    if _file_sha256(manifest_path) != sealed:
        return False, "manifest_hash_mismatch"
    try:
        with open(manifest_path) as f:
            files = dict(json.load(f)["files"])
    except (OSError, ValueError, KeyError, TypeError):
        return False, "manifest_unreadable"
    for rel, want in files.items():
        try:
            got = _file_sha256(os.path.join(path, rel))
        except OSError:
            return False, f"missing_file:{rel}"
        if got != want:
            return False, f"hash_mismatch:{rel}"
    # files outside the manifest are tolerated: GOOD is written later
    return True, "ok"


def is_valid_checkpoint(path: str, deep: bool = False) -> bool:
    """Whether ``path`` holds a complete checkpoint: a parseable
    ``config.json`` and a non-empty ``weights.pt``.  ``deep=True`` also
    verifies the manifest (``verify_manifest``); a checkpoint without one
    passes at the shallow level."""
    path = _abs(path)
    try:
        with open(os.path.join(path, CONFIG_FILE)) as f:
            RaftStereoConfig.from_dict(json.load(f))
        if not os.path.getsize(os.path.join(path, WEIGHTS_FILE)):
            return False
    except (OSError, ValueError, KeyError, TypeError, NotImplementedError):
        return False
    if deep:
        ok, reason = verify_manifest(path)
        if not ok:
            log.warning("checkpoint %s failed deep validation: %s", path,
                        reason)
            return False
    return True


def checkpoint_step(path: str) -> int:
    """The step a checkpoint records (-1 when unrecorded): the manifest,
    then ``COMMIT``, then a ``<step>_<name>`` directory name."""
    path = _abs(path)
    for meta in (MANIFEST_FILE, COMMIT_FILE):
        try:
            with open(os.path.join(path, meta)) as f:
                step = json.load(f).get("step")
            if step is not None:
                return int(step)
        except (OSError, ValueError, TypeError, AttributeError):
            continue
    prefix = os.path.basename(path).split("_", 1)[0]
    return int(prefix) if prefix.isdigit() else -1


def _run_entries(root: str, name: Optional[str]) -> List[str]:
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        return []
    out = []
    for entry in entries:
        if ".tmp-" in entry or ".old-" in entry:
            continue
        if name is not None and not (entry == name
                                     or entry.endswith(f"_{name}")):
            continue
        if os.path.isdir(os.path.join(root, entry)):
            out.append(entry)
    return out


def latest_checkpoint(checkpoint_dir: str, name: Optional[str] = None,
                      deep: bool = False,
                      on_reject: Optional[Callable[[str, str], None]] = None
                      ) -> Optional[str]:
    """The newest valid checkpoint under ``checkpoint_dir`` (of run
    ``name`` when given), or None: staging and retired orphans and torn
    directories are skipped, the highest recorded step wins (then the
    newest mtime).  ``deep=True`` verifies every candidate's manifest, so
    a flipped byte falls back to the newest checkpoint that verifies;
    ``on_reject(path, reason)`` hears of every candidate rejected."""
    root = _abs(checkpoint_dir)
    best: Optional[str] = None
    best_key = (-1, -1.0)
    for entry in _run_entries(root, name):
        path = os.path.join(root, entry)
        if not is_valid_checkpoint(path, deep=deep):
            if on_reject is not None:
                reason = "invalid"
                if deep:
                    ok, why = verify_manifest(path)
                    reason = why if not ok else "invalid"
                on_reject(path, reason)
            continue
        key = (checkpoint_step(path), os.path.getmtime(path))
        if key > best_key:
            best, best_key = path, key
    return best


def valid_checkpoints(checkpoint_dir: str, name: Optional[str] = None,
                      deep: bool = True) -> List[str]:
    """Every valid checkpoint of run ``name``, newest step first: the
    rewind's candidates, probed in this order."""
    root = _abs(checkpoint_dir)
    found = []
    for entry in _run_entries(root, name):
        path = os.path.join(root, entry)
        if is_valid_checkpoint(path, deep=deep):
            found.append((checkpoint_step(path), os.path.getmtime(path),
                          path))
    return [p for _, _, p in sorted(found, reverse=True)]


def load_runtime_state(path: str) -> Optional[Dict[str, Any]]:
    """The loop's exact-resume sidecar, or None on a checkpoint saved
    without one."""
    try:
        with open(os.path.join(_abs(path), RUNTIME_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ------------------------------------------------------ GOOD stamp + prune
def mark_good(path: str) -> None:
    """Stamp a checkpoint GOOD: a restore of it passed the finite-state
    probe.  Advisory metadata written after the seal (not in the
    manifest); the rewind re-probes either way."""
    try:
        _write_json(os.path.join(_abs(path), GOOD_FILE), {})
    except OSError:  # pragma: no cover - read-only checkpoint dir
        log.warning("could not stamp GOOD on %s", path)


def is_good(path: str) -> bool:
    return os.path.exists(os.path.join(_abs(path), GOOD_FILE))


def prune_checkpoints(checkpoint_dir: str, name: Optional[str] = None,
                      keep: int = 3) -> List[str]:
    """Keep the newest ``keep`` periodic ``<step>_<name>`` checkpoints;
    the final ``<name>`` checkpoint and the newest GOOD-stamped one (the
    rewind target) are never pruned.  Returns the removed paths."""
    if keep <= 0:
        return []
    root = _abs(checkpoint_dir)
    ranked = []
    for entry in _run_entries(root, name):
        if name is not None and entry == name:
            continue
        path = os.path.join(root, entry)
        ranked.append((checkpoint_step(path), os.path.getmtime(path), path))
    ranked.sort(reverse=True)
    newest_good = next((p for _, _, p in ranked if is_good(p)), None)
    removed = []
    for _, _, path in ranked[keep:]:
        if path == newest_good:
            continue
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
        log.info("pruned checkpoint %s (keep-last-%d)", path, keep)
    return removed
