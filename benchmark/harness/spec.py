"""Where a cell's pieces live, found by the names in ``BENCHMARK.json``.

- the configuration ``<config>``: the file its ``configs`` entry names
  (under ``benchmark/configs/``), the model and optimizer fields as run;
- the traffic mix ``<traffic>``: ``benchmark/traffic/<traffic>.json``, the
  parameters the driver it names reads;
- the driver ``<driver>``: ``benchmark/drivers/<driver>.py``, which runs one
  path of the port (``Driver`` class);
- a per-layer metric ``<name>``: ``benchmark/readers/<name>.py``, or, for a
  metric named ``<base>.<suffix>``, ``benchmark/readers/<base>.py``
  (``read(trace) -> float | None``).

A later change adds a configuration, a mix, a cell or a metric as new files
and entries; none of these files is edited for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    path = root / 'BENCHMARK.json'
    if not path.is_file():
        raise FileNotFoundError(f'{path} is missing')
    return json.loads(path.read_text())


def cell(bench: Dict[str, Any], workload: str) -> Dict[str, Any]:
    for w in bench['workloads']:
        if w['name'] == workload:
            return w
    raise KeyError(f'no workload {workload!r} in BENCHMARK.json; one of '
                   f'{[w["name"] for w in bench["workloads"]]}')


def config_entry(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for c in bench['configs']:
        if c['name'] == name:
            return c
    raise KeyError(f'no configuration {name!r} in BENCHMARK.json')


def load_json(root: Path, rel: str) -> Dict[str, Any]:
    return json.loads((root / rel).read_text())


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return root / 'benchmark' / 'traffic' / f'{name}.json'


def driver_path(name: str, root: Path = ROOT) -> Path:
    return root / 'benchmark' / 'drivers' / f'{name}.py'


def reader_path(metric: str, root: Path = ROOT) -> Optional[Path]:
    """The reader of a per-layer metric: its own file, else its base's."""
    readers = root / 'benchmark' / 'readers'
    for stem in (metric, metric.split('.', 1)[0]):
        p = readers / f'{stem}.py'
        if p.is_file():
            return p
    return None


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(bench, workload: str) -> List[Dict[str, Any]]:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench['end_to_end']
            if workload in m.get('workloads', [workload])]


def per_layer(bench, workload: str) -> List[Dict[str, Any]]:
    """The per-layer metrics a cell reports."""
    return [m for m in bench['per_layer']
            if workload in m.get('workloads', [workload])]


def build_dataclass(cls, values: Dict[str, Any], defaulted=None,
                    prefix: str = ''):
    """``cls`` from the JSON ``values``, nested dataclasses and tuples
    rebuilt.  A key that is no field is refused; a field the file does not
    name takes the dataclass's default, and its dotted name is appended to
    ``defaulted`` (the run prints them), so a field the program adds later
    needs no edit of a configuration file."""
    extra = set(values) - {f.name for f in dataclasses.fields(cls)}
    if extra:
        raise KeyError(f'{cls.__name__} has no fields {sorted(extra)}')
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            if defaulted is not None:
                defaulted.append(prefix + f.name)
            continue
        v = values[f.name]
        default = getattr(cls(), f.name) if _constructible(cls) else None
        if dataclasses.is_dataclass(default):
            v = build_dataclass(type(default), v, defaulted,
                                f'{prefix}{f.name}.')
        elif isinstance(v, list):
            v = _tuples(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def _constructible(cls) -> bool:
    try:
        cls()
        return True
    except TypeError:
        return False


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def as_json(obj) -> Any:
    """A dataclass as JSON values (tuples as lists)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: as_json(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [as_json(x) for x in obj]
    return obj
