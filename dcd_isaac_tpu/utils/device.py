"""What the program ran on: device identity and peak device memory."""

from __future__ import annotations

from typing import Optional

import jax


def device_summary() -> dict:
    """``{'platform', 'kind', 'count'}`` as JAX reports the devices."""
    devs = jax.devices()
    return {'platform': devs[0].platform, 'kind': devs[0].device_kind,
            'count': len(devs)}


def peak_bytes_in_use() -> Optional[int]:
    """Largest ``peak_bytes_in_use`` over this process's devices (None when
    the backend keeps no memory statistics, as the CPU backend may not)."""
    peaks = [(d.memory_stats() or {}).get('peak_bytes_in_use')
             for d in jax.local_devices()]
    peaks = [p for p in peaks if p is not None]
    return max(peaks) if peaks else None


def device_report() -> str:
    """One greppable line: platform, kind, count and peak device memory."""
    d = device_summary()
    return (f"device platform={d['platform']} kind={d['kind']!r} "
            f"count={d['count']} peak_bytes_in_use={peak_bytes_in_use()}")


if __name__ == '__main__':
    import json
    print(json.dumps(device_summary()))
