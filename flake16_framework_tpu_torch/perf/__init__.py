"""The tuning plane: the autotuner (``tune``), a copy of the JAX
package's ``perf/``.

``perf.tuner`` owns the declared knob space (KNOBSPACE — the typed
registry the lint's G108 audits kernel constants against) and the
probe-in-the-loop search that turns it into ``tuned`` perfdb rows the
plan executor consults (obs/perfdb.tuned_fit_overrides); ``perf.probe``
holds the probe's configs and data. Import-light on purpose: no torch
at import, so the lint census and the CLI help path never touch a
device."""

from flake16_framework_tpu_torch.perf.tuner import (  # noqa: F401
    KNOBSPACE,
    Knob,
    knobspace,
    registered_env_names,
    tune_main,
)
