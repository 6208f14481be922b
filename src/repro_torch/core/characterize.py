"""Characterisation sweep driver: the paper's full experimental grid.

Sweeps (arch x phase x batch x seq x lever) and emits flat records for the
benchmark tables/figures and the CSV artefacts. This is the programmatic
equivalent of the paper's §3.2 design: five clock levels, five cap levels,
batches 1..32, sequences 1K..64K.
"""
from __future__ import annotations

import csv
import dataclasses
import io
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.core.dvfs import ClockLock, Default, PowerCap, resolve
from repro_torch.core.energy import EnergyModel
from repro_torch.core.workload import decode_workload, prefill_workload
from repro_torch.models.config import ModelConfig

DEFAULT_BATCHES = (1, 4, 8, 16, 32)
DEFAULT_SEQS = (1024, 4096, 16384, 65536)


@dataclasses.dataclass(frozen=True)
class Record:
    arch: str
    paradigm: str
    phase: str            # prefill | decode
    batch: int
    seq: int
    lever: str            # default | lock | cap
    configured: float
    actual_clock_mhz: float
    engaged: bool
    power_w: float
    throughput: float
    energy_per_token_mj: float
    tokens_per_joule: float
    dominant: str
    fused: bool

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def characterize(
    model: EnergyModel,
    cfgs: Dict[str, ModelConfig],
    *,
    paradigms: Optional[Dict[str, str]] = None,
    batches: Sequence[int] = DEFAULT_BATCHES,
    seqs: Sequence[int] = DEFAULT_SEQS,
    phases: Sequence[str] = ("decode", "prefill"),
    fused: bool = False,
) -> List[Record]:
    paradigms = paradigms or {}
    spec = model.spec
    levers = (
        [("default", Default())]
        + [("lock", ClockLock(c)) for c in spec.clock_levels]
        + [("cap", PowerCap(c)) for c in spec.power_cap_levels]
    )
    out: List[Record] = []
    for name, cfg in cfgs.items():
        for phase in phases:
            for b in batches:
                for s in seqs:
                    if phase == "decode":
                        w = decode_workload(cfg, b, s, fused=fused)
                    else:
                        w = prefill_workload(cfg, b, s, fused=fused)
                    for lever_name, lever in levers:
                        op = resolve(model, w, lever)
                        out.append(
                            Record(
                                arch=name,
                                paradigm=paradigms.get(name, cfg.family),
                                phase=phase,
                                batch=b,
                                seq=s,
                                lever=lever_name,
                                configured=op.configured,
                                actual_clock_mhz=op.actual_clock_mhz,
                                engaged=op.engaged,
                                power_w=op.power_w,
                                throughput=op.throughput,
                                energy_per_token_mj=op.energy_per_token_mj,
                                tokens_per_joule=op.tokens_per_joule,
                                dominant=op.profile.dominant,
                                fused=fused,
                            )
                        )
    return out


def to_csv(records: Iterable[Record]) -> str:
    records = list(records)
    if not records:
        return ""
    buf = io.StringIO()
    writer = csv.DictWriter(buf, fieldnames=list(records[0].as_dict()))
    writer.writeheader()
    for r in records:
        writer.writerow(r.as_dict())
    return buf.getvalue()


def filter_records(records: Iterable[Record], **eq) -> List[Record]:
    out = []
    for r in records:
        if all(getattr(r, k) == v for k, v in eq.items()):
            out.append(r)
    return out
