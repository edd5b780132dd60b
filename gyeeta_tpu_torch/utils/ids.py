"""Machine identity + digest/encoding helpers.

The reference derives a stable 128-bit machine id from the OS
(``common/gy_sys_hardware.h`` SYS_HARDWARE: /etc/machine-id with DMI /
boot-id fallbacks) and carries SHA/base64 utilities for tokens and
payload digests (``common/gy_misc.h``). Agents register with this id;
the server's machine-id → host-id placement map keys on it.

Counterpart of ``gyeeta_tpu/utils/ids.py``: the standard library only.
"""

from __future__ import annotations

import base64
import hashlib
import pathlib
import socket
import uuid

_MACHINE_ID_PATHS = ("/etc/machine-id", "/var/lib/dbus/machine-id")


def machine_id() -> int:
    """Stable 128-bit machine identity.

    /etc/machine-id (systemd) first; DMI product UUID next; last resort
    a hash of hostname+MAC (stable per boot environment, weaker)."""
    for p in _MACHINE_ID_PATHS:
        try:
            text = pathlib.Path(p).read_text().strip()
            if text:
                return int(text, 16)
        except (OSError, ValueError):
            continue
    try:
        text = pathlib.Path(
            "/sys/class/dmi/id/product_uuid").read_text().strip()
        return uuid.UUID(text).int
    except (OSError, ValueError):
        pass
    seed = f"{socket.gethostname()}:{uuid.getnode():012x}".encode()
    return int.from_bytes(hashlib.sha256(seed).digest()[:16], "big")


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def b64_encode(data: bytes) -> str:
    return base64.b64encode(data).decode("ascii")


def b64_decode(text: str) -> bytes:
    return base64.b64decode(text)
