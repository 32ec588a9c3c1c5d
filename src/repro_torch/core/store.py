"""On-disk bitstream store: assembled overlay kernels that survive the process.

The paper's economics rest on *pre-synthesized* bitstreams: assembly is cheap
at runtime because synthesis already happened.  The port's kernel artifact
(:class:`~repro_torch.core.interpreter.Kernel`) is placement-free, keyed by
``kernel_key`` — graph name, abstract signature (shape, dtype, device) and
graph fingerprint — so it is valid for any later process on the same
runtime, wherever the fabric places it.  ``BitstreamStore`` persists those
artifacts to a directory so a restarted ``ServeEngine`` boots its kernels
from disk instead of building them.

Format (one file per artifact, named ``sha256(key).bits``):

    MAGIC (8 bytes)  b"RPROBITS"
    header length    uint32 little-endian
    header           JSON: {"format_version", "runtime": "torch", "torch",
                            "cuda", "capability", "key", "kind",
                            "payload_sha256", "payload_len"}
    payload          the kernel's serial form (:meth:`pack_kernel`):
                     b"RPTK" + uint32 length + a JSON step list that names
                     every operator (library entry, pattern, cast, aten
                     overload or registered call, with tagged constant
                     arguments) + the const payloads written by
                     ``torch.save`` and read back with ``weights_only=True``

No code is unpickled: a load resolves names and tags, and anything it cannot
resolve makes the entry unusable.  Every load re-validates magic, format
version, runtime (torch and CUDA versions, the card's compute capability),
key and the payload checksum; *any* mismatch — truncation, corruption, an
upgrade, an entry the JAX package wrote into the same directory — logs a
warning, deletes the entry and returns ``None`` so the caller builds the
kernel cold (and persists it again).  A store
can therefore never crash a boot and never serves a stale or foreign
artifact.

Writes are atomic (temp file in the same directory + ``os.replace``) so
readers — including overlays sharing one store directory — never observe a
half-written entry.  In-process, a single ``threading.Lock`` serializes
writers; across processes the atomic replace is the only contract (last
writer wins, which is safe because entries are content-keyed: both writers
hold the same bytes for the same key).

Alongside the artifacts the store keeps ``ledger.json``: the Fabric's
download-cost EWMA ledger and per-resident dispatch-latency histogram states,
so a warm boot re-seeds the placement planner's measurements instead of
starting blind (see ``Fabric.export_ledger`` / ``seed_ledger``).

Port of ``repro/core/store.py``: the same file format and contract, with a
header naming the torch runtime in place of ``jaxlib`` and a payload that
names operators in place of a pickled XLA executable.
"""

from __future__ import annotations

import hashlib
import json
import logging
import io
import os
import threading
import time
from dataclasses import dataclass

import torch

logger = logging.getLogger(__name__)

_MAGIC = b"RPROBITS"
FORMAT_VERSION = 1
_LEDGER_NAME = "ledger.json"


_PAYLOAD_MAGIC = b"RPTK"


def runtime_header() -> dict:
    """What an artifact was built against: the torch and CUDA versions and
    the compute capability of the card (None without one).  An entry whose
    header differs in any field is unusable here."""
    cap = None
    if torch.cuda.is_available():
        cap = "%d.%d" % torch.cuda.get_device_capability(0)
    return {"runtime": "torch", "torch": torch.__version__,
            "cuda": torch.version.cuda, "capability": cap}


@dataclass
class StoreStats:
    """Counters for one store instance (in-process; survives nothing)."""

    saves: int = 0
    loads: int = 0               # entries read and validated
    load_failures: int = 0
    invalidations: int = 0
    bytes_written: int = 0
    bytes_read: int = 0
    # seconds reading and validating entries (rebuilding the kernel from a
    # payload is the cache's store_load_seconds)
    load_seconds: float = 0.0
    injected_write_faults: int = 0
    injected_read_faults: int = 0
    unpersistable: int = 0       # kernels with no serial form, not written

    def as_dict(self) -> dict:
        return {
            "saves": self.saves,
            "loads": self.loads,
            "load_failures": self.load_failures,
            "invalidations": self.invalidations,
            "bytes_written": self.bytes_written,
            "bytes_read": self.bytes_read,
            "load_seconds": round(self.load_seconds, 6),
            "injected_write_faults": self.injected_write_faults,
            "injected_read_faults": self.injected_read_faults,
            "unpersistable": self.unpersistable,
        }


@dataclass
class _Entry:
    key: str
    kind: str
    path: str
    payload_len: int


class BitstreamStore:
    """Directory-backed artifact store for compiled overlay kernels.

    Thread-safe; one instance may be shared by every member of a
    ``FleetOverlay`` (a single in-process lock serializes writers, and
    atomic replace keeps concurrent *processes* from corrupting entries).
    """

    __locklint_shared__ = {
        "_index": "BitstreamStore._lock",
    }

    def __init__(self, path: str, *, faults=None) -> None:
        self.path = os.path.abspath(str(path))
        os.makedirs(self.path, exist_ok=True)
        self.stats = StoreStats()
        # optional FaultPlan (DESIGN.md §12): "store_write" garbles a blob
        # before it lands on disk (an interrupted/corrupting write that the
        # next load must reject), "store_read" flips bytes before
        # validation (media corruption the checksum chain must catch)
        self.faults = faults
        self._lock = threading.Lock()
        self._runtime = runtime_header()
        # key -> _Entry for entries this instance has seen (written or
        # scanned); the filesystem stays the source of truth for loads.
        self._index: dict[str, _Entry] = {}
        self._scan()

    # -- naming ----------------------------------------------------------

    @staticmethod
    def _file_for(key: str) -> str:
        return hashlib.sha256(key.encode("utf-8")).hexdigest() + ".bits"

    def _path_for(self, key: str) -> str:
        return os.path.join(self.path, self._file_for(key))

    def _scan(self) -> None:
        """Index existing entries (header-only read; payloads stay lazy).
        Directory I/O runs outside the lock — only the index update is
        serialized."""
        try:
            names = os.listdir(self.path)
        except OSError:
            return
        found: list[_Entry] = []
        for name in names:
            if not name.endswith(".bits"):
                continue
            full = os.path.join(self.path, name)
            header = self._read_header(full)
            if header is None or header.get("runtime") != "torch":
                continue                  # foreign: not this runtime's entry
            found.append(_Entry(
                key=header["key"],
                kind=header.get("kind", "kernel"),
                path=full,
                payload_len=int(header.get("payload_len", 0)),
            ))
        with self._lock:
            for ent in found:
                self._index[ent.key] = ent

    @staticmethod
    def _read_header(path: str) -> dict | None:
        try:
            with open(path, "rb") as f:
                magic = f.read(len(_MAGIC))
                if magic != _MAGIC:
                    return None
                raw_len = f.read(4)
                if len(raw_len) != 4:
                    return None
                hdr_len = int.from_bytes(raw_len, "little")
                if hdr_len <= 0 or hdr_len > 1 << 20:
                    return None
                raw = f.read(hdr_len)
                if len(raw) != hdr_len:
                    return None
                header = json.loads(raw.decode("utf-8"))
                if not isinstance(header, dict) or "key" not in header:
                    return None
                return header
        except (OSError, ValueError, UnicodeDecodeError):
            return None

    # -- queries ---------------------------------------------------------

    def __contains__(self, key: str) -> bool:
        with self._lock:
            if key in self._index:
                return True
        return os.path.exists(self._path_for(key))

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._index)

    def entry_kind(self, key: str) -> str | None:
        with self._lock:
            ent = self._index.get(key)
            return ent.kind if ent is not None else None

    # -- save / load -----------------------------------------------------

    def save(self, key: str, payload_blob: bytes, *, kind: str = "kernel") -> bool:
        """Atomically write one serialized artifact.

        ``payload_blob`` is a kernel's serial form (:meth:`pack_kernel`) —
        serialization itself happens on the caller's (low-lane worker)
        thread so no torch work runs under the store lock.
        """
        header = {
            "format_version": FORMAT_VERSION,
            **self._runtime,
            "key": key,
            "kind": kind,
            "payload_sha256": hashlib.sha256(payload_blob).hexdigest(),
            "payload_len": len(payload_blob),
        }
        raw_header = json.dumps(header, sort_keys=True).encode("utf-8")
        blob = (
            _MAGIC
            + len(raw_header).to_bytes(4, "little")
            + raw_header
            + payload_blob
        )
        if self.faults is not None and self.faults.fires("store_write", key):
            # injected write corruption: the entry lands truncated mid-
            # payload, exactly like a torn write the atomic replace cannot
            # guard against (e.g. power loss after the replace).  The next
            # load's validation chain rejects it and cold-compiles.
            blob = blob[: max(len(_MAGIC), len(blob) // 2)]
            self.stats.injected_write_faults += 1
        final = self._path_for(key)
        tmp = final + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with self._lock:
            try:
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, final)
            except OSError as exc:
                logger.warning("bitstream store: save failed for %r: %s", key, exc)
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return False
            self._index[key] = _Entry(
                key=key, kind=kind, path=final, payload_len=len(payload_blob)
            )
            self.stats.saves += 1
            self.stats.bytes_written += len(blob)
        return True

    def load_blob(self, key: str) -> bytes | None:
        """Read + validate one entry; returns its payload (a kernel's serial
        form, :meth:`unpack_kernel`).

        A missing file is a plain miss.  Any other failure — bad magic,
        version or runtime mismatch, truncated payload, checksum mismatch —
        warns, deletes the file and returns ``None``; the caller
        cold-compiles and persists the key again.
        """
        path = self._path_for(key)
        t0 = time.perf_counter()
        with self._lock:
            reason = None
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                return None  # plain miss: not an error
            if data and self.faults is not None \
                    and self.faults.fires("store_read", key):
                # injected read corruption: flip a byte mid-blob before
                # validation — the magic/header/checksum chain must catch
                # it and degrade to a cold compile, never crash
                mid = len(data) // 2
                data = data[:mid] + bytes([data[mid] ^ 0xFF]) + data[mid + 1:]
                self.stats.injected_read_faults += 1
            self.stats.bytes_read += len(data)
            header = None
            if data[: len(_MAGIC)] != _MAGIC:
                reason = "bad magic"
            else:
                off = len(_MAGIC)
                if len(data) < off + 4:
                    reason = "truncated header length"
                else:
                    hdr_len = int.from_bytes(data[off : off + 4], "little")
                    off += 4
                    if hdr_len <= 0 or len(data) < off + hdr_len:
                        reason = "truncated header"
                    else:
                        try:
                            header = json.loads(data[off : off + hdr_len])
                        except (ValueError, UnicodeDecodeError):
                            reason = "unparseable header"
                        off += hdr_len
            if reason is None and header is not None:
                payload = data[off:]
                stale = [f for f in self._runtime if not isinstance(header, dict)
                         or header.get(f) != self._runtime[f]]
                if not isinstance(header, dict):
                    reason = "unparseable header"
                elif header.get("format_version") != FORMAT_VERSION:
                    reason = f"format version {header.get('format_version')!r}"
                elif stale:
                    reason = "runtime " + ", ".join(
                        f"{f} {header.get(f)!r} != {self._runtime[f]!r}"
                        for f in stale)
                elif header.get("key") != key:
                    reason = "key mismatch"
                elif len(payload) != header.get("payload_len"):
                    reason = "truncated payload"
                elif (
                    hashlib.sha256(payload).hexdigest()
                    != header.get("payload_sha256")
                ):
                    reason = "payload checksum mismatch"
                else:
                    self.stats.loads += 1
                    self.stats.load_seconds += time.perf_counter() - t0
                    return payload
            self.stats.load_failures += 1
            self._index.pop(key, None)
            # unlike the reference, drop the bad file: the cold build then
            # persists the key afresh instead of every later boot failing
            # on it again (a save would skip a key whose file exists)
            try:
                os.unlink(path)
            except OSError:
                pass
            logger.warning(
                "bitstream store: entry for %r unusable (%s); cold compiling",
                key,
                reason,
            )
            return None

    def note_unusable(self, key: str) -> None:
        """Caller-side deserialization failed: count the failure and drop
        the entry — a payload that passes the checksum but cannot rebuild
        a kernel is permanently bad for this runtime (e.g. it names an
        operator or a tag this build does not have)."""
        with self._lock:
            self.stats.load_failures += 1
            self._index.pop(key, None)
            try:
                os.unlink(self._path_for(key))
            except OSError:
                pass

    def note_unpersistable(self, key: str, reason: Exception) -> None:
        """A kernel with no serial form (an operator built from an arbitrary
        callable, a const that is neither a tensor nor a number) was not
        written.  It still serves from memory; a later boot builds it."""
        with self._lock:
            self.stats.unpersistable += 1
        logger.info("bitstream store: %r not persisted (%s)", key, reason)

    # -- invalidation ----------------------------------------------------

    def delete(self, key: str) -> bool:
        with self._lock:
            self._index.pop(key, None)
            try:
                os.unlink(self._path_for(key))
            except OSError:
                return False
            self.stats.invalidations += 1
            return True

    def delete_many(self, keys) -> int:
        dropped = 0
        for key in list(keys):
            if self.delete(key):
                dropped += 1
        return dropped

    def delete_prefix(self, prefix: str) -> int:
        """Drop every indexed entry whose key starts with ``prefix`` —
        e.g. ``f"{kernel_key}|spec|"`` sweeps all route-constant variants
        of a dropped kernel."""
        return self.delete_many([k for k in self.keys()
                                 if k.startswith(prefix)])

    # -- measurement ledger ----------------------------------------------

    def save_ledger(self, ledger: dict, *, merge: bool = True) -> bool:
        """Persist the fabric measurement ledger (download-cost EWMA +
        dispatch-latency histogram states).

        With ``merge`` (the default) existing on-disk entries for *other*
        residents are kept — fleet members sharing one directory each
        contribute their own rows without clobbering the others'.
        """
        path = os.path.join(self.path, _LEDGER_NAME)
        with self._lock:
            merged = ledger
            if merge:
                existing = self._read_ledger_unlocked(path)
                if existing:
                    merged = dict(existing)
                    for section, rows in ledger.items():
                        if isinstance(rows, dict):
                            base = dict(merged.get(section) or {})
                            base.update(rows)
                            merged[section] = base
                        else:
                            merged[section] = rows
            tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(merged, f, sort_keys=True)
                os.replace(tmp, path)
            except (OSError, TypeError, ValueError) as exc:
                logger.warning("bitstream store: ledger save failed: %s", exc)
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return False
        return True

    def load_ledger(self) -> dict | None:
        path = os.path.join(self.path, _LEDGER_NAME)
        with self._lock:
            return self._read_ledger_unlocked(path)

    @staticmethod
    def _read_ledger_unlocked(path: str) -> dict | None:
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except OSError:
            return None
        except (ValueError, UnicodeDecodeError) as exc:
            logger.warning("bitstream store: ledger unreadable (%s); ignoring", exc)
            return None
        if not isinstance(data, dict):
            logger.warning("bitstream store: ledger malformed; ignoring")
            return None
        return data

    # -- artifact (de)serialization helpers ------------------------------

    @staticmethod
    def pack_kernel(kernel) -> bytes:
        """Serialize a :class:`~repro_torch.core.interpreter.Kernel` (or a
        ``SpecializedKernel``) into a durable payload blob.  Raises
        :class:`~repro_torch.core.trace.SerialError` when an operator or a
        const has no serial form: such a kernel is not persisted."""
        from repro_torch.core.trace import SerialError

        program, consts = kernel.serial_form()
        for c in consts:
            if not isinstance(c, (torch.Tensor, bool, int, float)):
                raise SerialError(f"kernel {kernel.name!r}: a const of type "
                                  f"{type(c).__name__} has no serial form")
        raw = json.dumps(program, sort_keys=True, allow_nan=False).encode("utf-8")
        buf = io.BytesIO()
        torch.save(list(consts), buf)
        return _PAYLOAD_MAGIC + len(raw).to_bytes(4, "little") + raw + buf.getvalue()

    @staticmethod
    def unpack_kernel(blob: bytes):
        """Rebuild a kernel from :meth:`pack_kernel`'s blob; raises on any
        malformed payload (callers catch and build cold).  Operators are
        resolved by name and consts read with ``weights_only=True``: nothing
        in the blob is run."""
        from repro_torch.core.interpreter import Kernel
        from repro_torch.core.trace import SerialError

        n = len(_PAYLOAD_MAGIC)
        if blob[:n] != _PAYLOAD_MAGIC or len(blob) < n + 4:
            raise SerialError("not a kernel payload")
        raw_len = int.from_bytes(blob[n:n + 4], "little")
        raw = blob[n + 4:n + 4 + raw_len]
        if len(raw) != raw_len:
            raise SerialError("truncated kernel program")
        program = json.loads(raw.decode("utf-8"))
        consts = torch.load(io.BytesIO(blob[n + 4 + raw_len:]), weights_only=True)
        if not isinstance(program, dict) or not isinstance(consts, list):
            raise SerialError("malformed kernel payload")
        return Kernel.from_serial(program, consts)

    def describe(self) -> dict:
        with self._lock:
            kinds: dict[str, int] = {}
            total = 0
            for ent in self._index.values():
                kinds[ent.kind] = kinds.get(ent.kind, 0) + 1
                total += ent.payload_len
            return {
                "path": self.path,
                "entries": len(self._index),
                "kinds": kinds,
                "payload_bytes": total,
                "stats": self.stats.as_dict(),
            }


__all__ = ["BitstreamStore", "StoreStats", "FORMAT_VERSION", "runtime_header"]
