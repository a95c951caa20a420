"""The two data-collection pytest plugins (copies of the JAX package's
``plugins/``), with their contracts:

- **showflakes**: per-test outcome recording with optional order
  shuffling (``--record-file=<f>.tsv``, ``--shuffle``,
  ``--set-exitstatus``).
- **testinspect**: one instrumented run writing ``<f>.sqlite3`` (per-test
  line coverage), ``<f>.tsv`` (6 rusage floats + nodeid) and ``<f>.pkl``
  (static features, test files, per-line git churn)
  (``--testinspect=<f>``).

They install into arbitrary subject virtualenvs, so they need the
standard library and psutil only: no coverage.py (lines are traced with
``sys.monitoring``), no radon (static metrics are an ``ast`` walk), and
no torch or numpy (importing this package pulls in neither).

They are not ``pytest11`` entry points: the JAX package's plugins are,
under the same names and options, and the two sets cannot load into one
pytest process. Select them explicitly, with the entry points blocked:
``-p no:showflakes -p no:testinspect -p
flake16_framework_tpu_torch.plugins.showflakes -p
flake16_framework_tpu_torch.plugins.testinspect``
(``runner/containers.PLUGIN_SELECT``).
"""
