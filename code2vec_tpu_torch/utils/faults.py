"""Fault-injection hook points for crash tests.

The port's copy of code2vec_tpu/utils/faults.py (:101-187), with its
`fault_injected_total{point,action}` counter of fired faults (:182).
Code calls `fault_point("name")` where a crash is interesting (between
the files of a checkpoint save). The hooks
do nothing beyond one dict check unless the `C2V_FAULTS` environment
variable, or an explicit `reset(spec)` in-process, arms them.

Spec grammar (comma-separated):

    C2V_FAULTS="<point>[@N][=<action>][,<point2>...]"

- `<point>`  the name passed to `fault_point`.
- `@N`       trigger on the Nth hit of that point (1-based; default 1),
             counted per name across the process: `save@3=exit` kills
             the process at the third `save` hook crossed since arming.
- `<action>` `raise` (default): raise FaultInjected; `exit`:
             `os._exit(FAULT_EXIT_CODE)`, a hard kill with no cleanup,
             the in-process stand-in for SIGKILL or power loss.

The spec is parsed at the first `fault_point` call and cached:
subprocess tests set the variable before the interpreter starts,
in-process tests call `reset("...")` / `reset(None)`.

Fault points of the checkpoint commit (training/checkpoint.py):

- `save` (x5)         between the staged files (1 staging created, 2
                      vocabularies, 3 meta, 4 state written, 5 manifest
                      written, not yet renamed)
- `async_commit`      start of the deferred commit work (state written,
                      manifest missing); on the commit thread in async
                      mode
- `checkpoint_commit` staged, rename pending
- `checkpoint_swap`   mid overwrite swap (the empty-slot window)
- `callback_crash`    committed, the content-hash pass and the
                      completion callback (rotation) still pending

Fault point of the resume path (model_facade._cursor_skip_rows):

- `cursor_remap`      the saved data cursor is being applied before the
                      resumed epoch's first batch; a kill here must leave
                      the artifact untouched and re-restorable

Serving (serving/admission.py): `admission_enqueue`, crossed on every
admission-gate admit.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

FAULTS_ENV = "C2V_FAULTS"
# a distinctive exit code: a test tells an injected kill from a crash
FAULT_EXIT_CODE = 43

_ACTIONS = ("raise", "exit")


class FaultInjected(RuntimeError):
    """Raised by an armed `raise`-action fault point."""


class FaultSpecError(ValueError):
    """A C2V_FAULTS spec that cannot be parsed (a typo'd spec that
    silently injected nothing would void the crash test)."""


# point name -> (trigger hit number, action); None = not parsed yet,
# {} = parsed and disarmed
_spec: Optional[Dict[str, Tuple[int, str]]] = None
_hits: Dict[str, int] = {}


def _parse(raw: str) -> Dict[str, Tuple[int, str]]:
    spec: Dict[str, Tuple[int, str]] = {}
    for clause in filter(None, (c.strip() for c in raw.split(","))):
        point, _, action = clause.partition("=")
        action = action or "raise"
        if action not in _ACTIONS:
            raise FaultSpecError(
                f"bad {FAULTS_ENV} clause {clause!r}: action {action!r} "
                f"not in {_ACTIONS}")
        point, _, nth = point.partition("@")
        try:
            n = int(nth) if nth else 1
        except ValueError:
            raise FaultSpecError(
                f"bad {FAULTS_ENV} clause {clause!r}: hit count {nth!r} "
                f"is not an integer")
        if not point or n < 1:
            raise FaultSpecError(f"bad {FAULTS_ENV} clause {clause!r}")
        spec[point] = (n, action)
    return spec


def reset(spec: Optional[str] = "") -> None:
    """(Re)arm the fault points: `reset("save@2=raise")` arms in-process,
    `reset()` re-reads the environment at the next hit, `reset(None)`
    disarms."""
    global _spec
    _hits.clear()
    if spec is None:
        _spec = {}
    elif spec == "":
        _spec = None
    else:
        _spec = _parse(spec)


def fault_point(name: str) -> None:
    """Cross a named fault point: a no-op (one dict check) unless armed."""
    global _spec
    if _spec is None:
        _spec = _parse(os.environ.get(FAULTS_ENV, ""))
    if not _spec:
        return
    armed = _spec.get(name)
    if armed is None:
        return
    _hits[name] = _hits.get(name, 0) + 1
    n, action = armed
    if _hits[name] != n:
        return
    # counted so `raise`-action drills can read from the registry which
    # fault fired; an `exit` dies with the process before any export.
    # Imported here: the unarmed path stays one dict check.
    from code2vec_tpu_torch import obs
    obs.counter("fault_injected_total",
                "armed fault points that fired",
                point=name, action=action).inc()
    if action == "exit":
        os._exit(FAULT_EXIT_CODE)
    raise FaultInjected(f"injected fault at point {name!r} (hit {n})")
