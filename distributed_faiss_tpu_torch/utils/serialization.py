"""Shard persistence: index state_dicts as npz (arrays) + a json header,
plus the generation/MANIFEST layer (counterpart of
distributed_faiss_tpu/utils/serialization.py, same file formats).

Numeric arrays go in an npz — pickle-free, so a state written by either
package loads in the other. Every save is a numbered GENERATION of
suffixed files committed by a ``MANIFEST-g<gen>.json`` carrying each
file's sha256, written LAST via tmp+fsync+rename; loading verifies the
checksums and quarantines (renames, never deletes) a torn set.
"""

import hashlib
import json
import os
import re
import time

import numpy as np

_META_KEY = "__meta__"

MANIFEST_RE = re.compile(r"^MANIFEST-g(\d{8})\.json$")
GENFILE_RE = re.compile(r"^[a-z]+-g(\d{8})\.[a-z]+$")
QUARANTINE_DIR = "quarantine"


def save_state(path_or_file, state: dict) -> None:
    """Write a state dict (numpy arrays + json-able scalars) to a path or an
    open binary file object."""
    arrays = {}
    scalars = {}
    for k, v in state.items():
        if isinstance(v, np.ndarray):
            arrays[k] = v
        else:
            scalars[k] = v
    arrays[_META_KEY] = np.frombuffer(json.dumps(scalars).encode("utf-8"), dtype=np.uint8)
    if hasattr(path_or_file, "write"):
        np.savez(path_or_file, **arrays)
    else:
        with open(path_or_file, "wb") as f:
            np.savez(f, **arrays)


def load_state(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        state = {k: z[k] for k in z.files if k != _META_KEY}
        state.update(json.loads(bytes(z[_META_KEY].tobytes()).decode("utf-8")))
    return state


def atomic_write(path: str, write_fn, mode: str) -> str:
    """tmp + fsync + rename write; returns the sha256 of the bytes that
    landed."""
    tmp = path + ".tmp"
    with open(tmp, mode) as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    digest = sha256_file(tmp)
    os.replace(tmp, path)
    return digest


def sha256_file(path: str, chunk_bytes: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _canon(v):
    """A metadata value in a form whose ``repr`` is the same in every
    process: sets sort (their order follows string-hash randomization) and
    leaves other than basic types reduce to ``str`` (numpy scalars' repr
    changed between numpy 1 and 2)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (tuple, list)):
        return tuple(_canon(e) for e in v)
    if isinstance(v, (set, frozenset)):
        return ("set",) + tuple(sorted((_canon(e) for e in v), key=repr))
    if isinstance(v, dict):
        return ("dict",) + tuple(sorted(
            ((_canon(k), _canon(val)) for k, val in v.items()), key=repr))
    return str(v)


def row_payload_hash(embeddings, metadata, versions) -> str:
    """sha256 of one anti-entropy row chunk: the float32 embedding plane and
    the canonical metadata and version lists. The exporting engine sends it
    beside the rows and the pulling sweeper recomputes it over what arrived
    before applying anything (the JAX package's hash, byte for byte)."""
    h = hashlib.sha256()
    a = np.ascontiguousarray(np.asarray(embeddings, np.float32))
    h.update(str(a.shape).encode("utf-8"))
    h.update(a.tobytes())
    h.update(repr([_canon(m) for m in metadata]).encode("utf-8"))
    h.update(repr([_canon(v) for v in versions]).encode("utf-8"))
    return h.hexdigest()


def generation_filename(key: str, gen: int, ext: str) -> str:
    return f"{key}-g{gen:08d}.{ext}"


def manifest_path(storage_dir: str, gen: int) -> str:
    return os.path.join(storage_dir, f"MANIFEST-g{gen:08d}.json")


def write_manifest(storage_dir: str, gen: int, files: dict, extra=None) -> str:
    """Commit a generation: atomically write its manifest. Call only after
    every listed file is durably in place — this write is the commit
    point."""
    manifest = {"generation": gen, "created": time.time(), "files": files}
    if extra:
        manifest.update(extra)
    path = manifest_path(storage_dir, gen)
    atomic_write(path, lambda f: f.write(json.dumps(manifest, indent=1) + "\n"), "w")
    return path


def load_manifest(path: str) -> dict:
    with open(path) as f:
        manifest = json.load(f)
    if "generation" not in manifest or "files" not in manifest:
        raise ValueError(f"manifest {path} missing required keys")
    return manifest


def verify_manifest(storage_dir: str, manifest: dict) -> list:
    """Problems with the manifest's file set (empty list == complete)."""
    errors = []
    for key, entry in manifest["files"].items():
        path = os.path.join(storage_dir, entry["name"])
        if not os.path.exists(path):
            errors.append(f"{key}: {entry['name']} missing")
            continue
        digest = sha256_file(path)
        if digest != entry["sha256"]:
            errors.append(
                f"{key}: {entry['name']} sha256 mismatch "
                f"(want {entry['sha256'][:12]}.., got {digest[:12]}..)")
    return errors


def list_generations(storage_dir: str) -> list:
    """[(gen, manifest_path)] for every committed generation, NEWEST first."""
    if not os.path.isdir(storage_dir):
        return []
    found = []
    for name in os.listdir(storage_dir):
        m = MANIFEST_RE.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(storage_dir, name)))
    return sorted(found, reverse=True)


def _quarantine_file(storage_dir: str, name: str) -> None:
    qdir = os.path.join(storage_dir, QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    dst = os.path.join(qdir, name)
    if os.path.exists(dst):
        dst = f"{dst}.{time.monotonic_ns()}"
    os.replace(os.path.join(storage_dir, name), dst)


def quarantine_generation(storage_dir: str, gen: int, reason: str = "") -> list:
    """Move every file of generation ``gen`` into ``quarantine/`` (renames,
    never deletes). Returns the moved basenames."""
    moved = []
    for name in sorted(os.listdir(storage_dir)):
        m = MANIFEST_RE.match(name) or GENFILE_RE.match(name)
        if m and int(m.group(1)) == gen:
            _quarantine_file(storage_dir, name)
            moved.append(name)
    if moved:
        note = os.path.join(storage_dir, QUARANTINE_DIR, f"g{gen:08d}.reason.txt")
        try:
            with open(note, "a") as f:
                f.write(f"{time.time():.0f} {reason or 'torn generation'}\n")
        except OSError:
            pass  # the note is advisory; never fail the load path on it
    return moved


def quarantine_orphans(storage_dir: str, newer_than: int) -> list:
    """Quarantine generation files newer than the newest committed one (a
    crash between the data writes and the manifest leaves these)."""
    moved = []
    for name in sorted(os.listdir(storage_dir)):
        m = GENFILE_RE.match(name)
        if m and int(m.group(1)) > newer_than:
            _quarantine_file(storage_dir, name)
            moved.append(name)
    return moved


def quarantine_stale_tmps(storage_dir: str) -> list:
    """Quarantine ``*.tmp`` leftovers of atomic_write (load time only: no
    writer is active then, so any .tmp is abandoned)."""
    if not os.path.isdir(storage_dir):
        return []
    moved = []
    for name in sorted(os.listdir(storage_dir)):
        if name.endswith(".tmp") and os.path.isfile(os.path.join(storage_dir, name)):
            _quarantine_file(storage_dir, name)
            moved.append(name)
    return moved


def prune_generations(storage_dir: str, keep: int = 2) -> None:
    """Delete COMMITTED generations beyond the newest ``keep`` (>= 2: the
    crash-fallback generation always survives)."""
    for gen, mpath in list_generations(storage_dir)[keep:]:
        for name in sorted(os.listdir(storage_dir)):
            m = GENFILE_RE.match(name)
            if m and int(m.group(1)) == gen:
                os.unlink(os.path.join(storage_dir, name))
        os.unlink(mpath)
