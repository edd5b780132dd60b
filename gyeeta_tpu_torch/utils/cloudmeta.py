"""Cloud instance-metadata (IMDS) collector — config-gated.

The reference probes each cloud's metadata endpoint at startup for
instance id / region / zone (``common/gy_cloud_metadata.cc:27-67``:
AWS IMDSv2 token flow, GCP metadata-flavor header, Azure api-version
query). This build defaults to the NO-EGRESS stance — nothing is
queried unless ``GYT_CLOUD_META=1`` (the descope is a flag, not an
absence) — and the endpoint is injectable so tests run against a
local fake IMDS.

Returns ``None`` cleanly when disabled, unreachable, or on any
non-cloud box (the 169.254.169.254 link-local address answers only
inside cloud VMs; the probe uses short timeouts).

Counterpart of ``gyeeta_tpu/utils/cloudmeta.py``. Its two knobs,
``GYT_CLOUD_META`` and ``GYT_CLOUD_META_URL``, are read from the ``env``
mapping a caller hands over (``None`` means no environment, so the probe
stays off); only ``cli.py`` hands over ``os.environ``.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Optional

CLOUD_NONE, CLOUD_AWS, CLOUD_GCP, CLOUD_AZURE = 0, 1, 2, 3

_DEFAULT_BASE = "http://169.254.169.254"


def _get(url: str, headers: dict, timeout: float,
         method: str = "GET") -> Optional[str]:
    req = urllib.request.Request(url, headers=headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read().decode("utf-8", "replace")
    except (urllib.error.URLError, OSError, ValueError):
        return None


_cached: dict = {}


def detect(base: Optional[str] = None, timeout: float = 0.5,
           env=None) -> Optional[dict]:
    """→ {"cloud_type", "instance_id", "region", "zone"} or None.

    Gated: returns None unless ``env`` has ``GYT_CLOUD_META=1`` (or an
    explicit ``base`` is passed — tests and operators opting in). Probes
    AWS (IMDSv2 with v1 fallback), GCP, then Azure. The result is cached
    per endpoint — instance metadata is immutable for the VM's
    lifetime, and the probes are blocking HTTP calls that must not
    re-run inside the agent's reconnect path."""
    if base is None:
        env = {} if env is None else env
        if env.get("GYT_CLOUD_META") != "1":
            return None
        base = env.get("GYT_CLOUD_META_URL", _DEFAULT_BASE)
    if base in _cached:
        return _cached[base]
    out = _probe(base, timeout)
    _cached[base] = out
    return out


def _probe(base: str, timeout: float) -> Optional[dict]:

    # ---- AWS: IMDSv2 token, fall back to v1-style plain GET
    tok = _get(f"{base}/latest/api/token",
               {"X-aws-ec2-metadata-token-ttl-seconds": "60"},
               timeout, method="PUT")
    hdr = {"X-aws-ec2-metadata-token": tok} if tok else {}
    iid = _get(f"{base}/latest/meta-data/instance-id", hdr, timeout)
    if iid:
        az = _get(f"{base}/latest/meta-data/placement/"
                  f"availability-zone", hdr, timeout) or ""
        return {"cloud_type": CLOUD_AWS, "instance_id": iid.strip(),
                "region": az.strip()[:-1] if az.strip() else "",
                "zone": az.strip()}

    # ---- GCP: requires the Metadata-Flavor header
    g = _get(f"{base}/computeMetadata/v1/instance/id",
             {"Metadata-Flavor": "Google"}, timeout)
    if g:
        z = _get(f"{base}/computeMetadata/v1/instance/zone",
                 {"Metadata-Flavor": "Google"}, timeout) or ""
        zone = z.strip().rsplit("/", 1)[-1]
        return {"cloud_type": CLOUD_GCP, "instance_id": g.strip(),
                "region": zone.rsplit("-", 1)[0] if zone else "",
                "zone": zone}

    # ---- Azure: api-version query + Metadata header, JSON body
    a = _get(f"{base}/metadata/instance/compute"
             f"?api-version=2021-02-01", {"Metadata": "true"}, timeout)
    if a:
        try:
            c = json.loads(a)
            return {"cloud_type": CLOUD_AZURE,
                    "instance_id": str(c.get("vmId", "")),
                    "region": str(c.get("location", "")),
                    "zone": str(c.get("zone", ""))}
        except ValueError:
            pass
    return None
