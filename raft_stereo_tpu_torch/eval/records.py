"""JSON records of the port's measurement tools (the drift gates, the
sequence drift of ``cli/evaluate.py --stream_out``).

``write_record(path, record, device)`` writes the record with a ``run``
block naming what produced it: torch's and CUDA's versions and the device
(the card's name on the card).  It never overwrites a record of the JAX
package's tools (``QUANT_DRIFT_r22.json``, ``BF16_DRIFT_r05.json``,
``STREAM_ci.json``, every ``*_r<N>.json`` and ``BENCH_*.json``): those
are the reference's measurements, taken on other hardware.
"""

from __future__ import annotations

import datetime
import json
import os
import platform
import re
from pathlib import Path
from typing import Dict, Union

import torch

RECORDS_DIR = Path(__file__).resolve().parent.parent / "_build" / "records"
_PRE_PORT = re.compile(r"(BENCH_.*|[A-Z0-9_]+_(r\d+|ci))\.json")


def run_block(device: Union[str, torch.device]) -> Dict:
    """What produced a record: versions and the device."""
    device = torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "python": platform.python_version(), "device": name,
            "utc": datetime.datetime.now(datetime.timezone.utc).isoformat(
                timespec="seconds")}


def default_path(name: str) -> str:
    """``name`` under the package's git-ignored build directory."""
    return str(RECORDS_DIR / name)


def write_record(path: str, record: Dict,
                 device: Union[str, torch.device]) -> str:
    """Write ``record`` with its ``run`` block to ``path`` (directories
    made); refuses the file names of the JAX package's records."""
    if _PRE_PORT.fullmatch(os.path.basename(path)):
        raise ValueError(f"{path}: the name of a JAX package record; the "
                         f"port writes its own records elsewhere")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dict(record, run=run_block(device)), f, indent=1)
        f.write("\n")
    return path
