"""Minimal 5-field cron schedule parser/evaluator.

Plays the role of github.com/robfig/cron in the reference state machine
(controllers/statemachine/machine.go:252-255 computes next sync times from
``spec.trigger.schedule``). Supports the standard syntax the reference's
CRD validation admits: ``* N a-b a-b/s x,y,z`` per field, fields =
minute hour day-of-month month day-of-week (0=Sunday, 7 aliases to 0).

Ports ``volsync_tpu/controller/cron.py`` whole.
"""

from __future__ import annotations

import dataclasses
import functools
from datetime import datetime, timedelta

_RANGES = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]
_MONTH_NAMES = {n: i + 1 for i, n in enumerate(
    "jan feb mar apr may jun jul aug sep oct nov dec".split())}
_DOW_NAMES = {n: i for i, n in enumerate(
    "sun mon tue wed thu fri sat".split())}


class CronError(ValueError):
    pass


def _parse_atom(atom: str, lo: int, hi: int, names: dict) -> set[int]:
    step = 1
    has_step = "/" in atom
    if has_step:
        atom, step_s = atom.split("/", 1)
        try:
            step = int(step_s)
        except ValueError:
            raise CronError(f"bad step {step_s!r}") from None
        if step <= 0:
            raise CronError(f"bad step {step}")

    def value(tok: str) -> int:
        tok = tok.strip().lower()
        if tok in names:
            return names[tok]
        try:
            v = int(tok)
        except ValueError:
            raise CronError(f"bad value {tok!r}") from None
        return v

    dow = hi == 6
    if dow:
        hi = 7  # 7 is accepted as an alias of Sunday (vixie/robfig cron)
    if atom == "":
        raise CronError("empty list element (doubled or trailing comma)")
    if atom == "*":
        start, end = lo, hi if not dow else 6
    elif "-" in atom:
        a, b = atom.split("-", 1)
        start, end = value(a), value(b)
    else:
        start = end = value(atom)
        if has_step:  # "N/step" means N-hi/step (robfig/cron semantics)
            end = hi
    if not (lo <= start <= hi and lo <= end <= hi and start <= end):
        raise CronError(f"value out of range: {atom!r} not in [{lo},{hi}]")
    out = set(range(start, end + 1, step))
    if dow:  # fold the 7 alias onto Sunday ('5-7' == Fri,Sat,Sun)
        out = {0 if v == 7 else v for v in out}
    return out


def _parse_field(field: str, idx: int) -> set[int]:
    lo, hi = _RANGES[idx]
    names = _MONTH_NAMES if idx == 3 else (_DOW_NAMES if idx == 4 else {})
    out: set[int] = set()
    for atom in field.split(","):
        out |= _parse_atom(atom, lo, hi, names)
    return out


_MACROS = {
    "@hourly": "0 * * * *",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@weekly": "0 0 * * 0",
    "@monthly": "0 0 1 * *",
    "@yearly": "0 0 1 1 *",
    "@annually": "0 0 1 1 *",
}


@dataclasses.dataclass(frozen=True)
class Schedule:
    minutes: frozenset
    hours: frozenset
    dom: frozenset
    months: frozenset
    dow: frozenset
    dom_star: bool
    dow_star: bool

    def matches(self, t: datetime) -> bool:
        return (t.minute in self.minutes and t.hour in self.hours
                and t.month in self.months and self._day_matches(t))

    def _day_matches(self, t: datetime) -> bool:
        # Vixie-cron rule: if both dom and dow are restricted, either may
        # match; if only one is restricted, it must match.
        dom_ok = t.day in self.dom
        dow_ok = ((t.weekday() + 1) % 7) in self.dow  # py Mon=0 -> cron Sun=0
        if self.dom_star and self.dow_star:
            return True
        if self.dom_star:
            return dow_ok
        if self.dow_star:
            return dom_ok
        return dom_ok or dow_ok

    def next(self, after: datetime) -> datetime:
        """First fire time strictly after ``after`` (minute resolution).

        Field-wise search: walk days (cheap), then pick the first matching
        (hour, minute) within the day — O(days-to-fire), not O(minutes),
        so sparse schedules (e.g. Feb 29) stay sub-millisecond.
        """
        t = after.replace(second=0, microsecond=0) + timedelta(minutes=1)
        hours = sorted(self.hours)
        minutes = sorted(self.minutes)
        # 5 years of days covers any 5-field schedule incl. Feb 29.
        for _ in range(5 * 366):
            if t.month not in self.months or not self._day_matches(t):
                t = (t + timedelta(days=1)).replace(hour=0, minute=0)
                continue
            for h in hours:
                if h < t.hour:
                    continue
                for mi in minutes:
                    if h == t.hour and mi < t.minute:
                        continue
                    return t.replace(hour=h, minute=mi)
            t = (t + timedelta(days=1)).replace(hour=0, minute=0)
        raise CronError("schedule never fires")


@functools.lru_cache(maxsize=512)
def parse(spec: str) -> Schedule:
    spec = spec.strip()
    spec = _MACROS.get(spec, spec)
    fields = spec.split()
    if len(fields) != 5:
        raise CronError(f"need 5 fields, got {len(fields)}: {spec!r}")
    sets = [_parse_field(f, i) for i, f in enumerate(fields)]
    return Schedule(
        minutes=frozenset(sets[0]), hours=frozenset(sets[1]),
        dom=frozenset(sets[2]), months=frozenset(sets[3]),
        dow=frozenset(sets[4]),
        dom_star=fields[2] == "*", dow_star=fields[4] == "*",
    )
