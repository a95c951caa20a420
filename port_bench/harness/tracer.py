"""The traced window of a ``--trace 1`` run: ``torch.profiler`` (host and
CUDA activity) over a stretch of the driver's window that the driver
chooses, inside one ``port_bench.window`` range, with the metrics'
hooks installed for that stretch only.

A hook is what a per-layer metric file asks for in its ``HOOKS`` list:
``{"target": "module:attr"}`` or ``"module:Class.attr"`` (the name where
the program's caller looks the function up), the ``range`` that each call
is wrapped in (``record_function``), and optionally ``record(args,
kwargs)``, a dict kept for each call in the window (``Tracer.calls[
range]``, the dicts of every hook on that target and range merged). Hooks are installed and removed by the tracer,
so an untraced run measures the program as it is."""

import importlib

import torch

from port_bench.harness import timeline


def _resolve(target):
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr


class Tracer:
    """``start()`` and ``stop(**units)`` around the stretch to trace; a
    disabled tracer does nothing. After ``stop``: ``events`` (the
    timeline), ``calls`` ({range: [record, ...]}) and ``units`` (what the
    driver completed inside the stretch, e.g. ``configs=4``)."""

    def __init__(self, enabled, hooks=(), device=None):
        self.enabled = enabled
        self.hooks = list(hooks)
        self.device = device
        self.events = None
        self.calls = {}
        self.units = {}
        self.state = "idle"
        self._prof = None
        self._range = None
        self._saved = []

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _install(self):
        by_target = {}
        for h in self.hooks:
            by_target.setdefault((h["target"], h["range"]), []).append(
                h.get("record"))
        for (target, name), records in by_target.items():
            owner, attr = _resolve(target)
            fn = getattr(owner, attr)
            calls = self.calls.setdefault(name, [])
            records = [r for r in records if r is not None]

            def wrapped(*args, _fn=fn, _name=name, _calls=calls,
                        _records=records, **kwargs):
                rec = {}
                for r in _records:
                    rec.update(r(args, kwargs) or {})
                with torch.profiler.record_function(_name):
                    out = _fn(*args, **kwargs)
                _calls.append(rec)
                return out

            self._saved.append((owner, attr, fn))
            setattr(owner, attr, wrapped)

    def _uninstall(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []

    def start(self):
        if not self.enabled or self.state != "idle":
            return
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._install()
        self._sync()
        self._range = torch.profiler.record_function(timeline.WINDOW_RANGE)
        self._range.__enter__()
        self.state = "on"

    def stop(self, **units):
        if self.state != "on":
            return
        self._sync()
        self._range.__exit__(None, None, None)
        self._uninstall()
        self._prof.stop()
        self.units = units
        self.events = timeline.from_kineto(self._prof)
        self._prof = None
        self.state = "done"
