"""Collection orchestration (a copy of the JAX package's
``runner/containers.py``): subject provisioning, the in-container entry
point, the Docker fan-out and the ``log.txt`` resume ledger. The
contracts are the JAX package's:

- container naming ``{proj}_{mode}_{run_n}`` and the per-mode plugin
  flags (showflakes: ``--record-file=<f>.tsv`` [+ ``--shuffle``];
  testinspect: ``--testinspect=<f>``),
- the interfering-plugin blacklist and ``--set-exitstatus``,
- the 7200 s per-container timeout and ``--cpus=1`` isolation,
- the append-only ``log.txt`` ledger and exit status 1 on any failure,
- each container's stdout captured to ``stdout/<name>``.

Two differences from the JAX package's commands, and no others:

- ``docker_command`` runs ``python3 -m flake16_framework_tpu_torch
  container ...`` inside the image.
- ``container_entrypoint``'s pytest command selects this package's
  plugins. Setup installs the whole framework tree into each subject
  venv, so the JAX package's plugins load there as the ``pytest11``
  entry points ``showflakes`` and ``testinspect``. This package's copies
  register the same options and plugin names and take the same
  ``sys.monitoring`` tool, so the two sets cannot share a pytest
  process: the command blocks the entry points and loads this package's
  two plugins (``PLUGIN_SELECT``), right after the blacklist. Both load
  in every mode, as the entry points do, since the command always
  carries ``--set-exitstatus``, an option of showflakes.

Subprocess execution is injectable (``exec_fn``), so the layer is tested
without Docker.
"""

import functools
import os
import shlex
import shutil
import subprocess as sp
import sys

from flake16_framework_tpu_torch.constants import (
    CONT_DATA_DIR, CONT_TIMEOUT, DATA_DIR, IMAGE_NAME, LOG_FILE,
    N_RUNS, PIP_INSTALL, PIP_VERSION, PLUGIN_BLACKLIST, PLUGINS,
    REQUIREMENTS_FILE, STDOUT_DIR, SUBJECTS_DIR,
)
from flake16_framework_tpu_torch.runner.pool import run_pool
from flake16_framework_tpu_torch.runner.subjects import iter_subjects

MODE_FLAGS = {
    "testinspect": lambda f: [f"--testinspect={f}"],
    "baseline": lambda f: [f"--record-file={f}.tsv"],
    "shuffle": lambda f: [f"--record-file={f}.tsv", "--shuffle"],
}

PLUGIN_SELECT = (
    "-p", "no:showflakes", "-p", "no:testinspect",
    "-p", "flake16_framework_tpu_torch.plugins.showflakes",
    "-p", "flake16_framework_tpu_torch.plugins.testinspect",
)


def subject_paths(proj):
    base = os.path.join(SUBJECTS_DIR, proj)
    return {
        "checkout": os.path.join(base, proj),
        "venv_bin": os.path.join(base, "venv", "bin"),
        "requirements": os.path.join(base, "requirements.txt"),
        "venv": os.path.join(base, "venv"),
    }


def _venv_env(proj):
    env = os.environ.copy()
    env["PATH"] = subject_paths(proj)["venv_bin"] + ":" + env["PATH"]
    return env


def vendored_requirements(proj):
    """Path of the repository's pin file for ``proj``
    (``subjects/<proj>/requirements.txt`` beside the package: the study's
    frozen dependency resolutions), or None when there is none."""
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "subjects", proj, REQUIREMENTS_FILE,
    )
    return path if os.path.exists(path) else None


def provision_subject(subject, exec_fn=sp.run):
    """Build one subject's pinned virtualenv: venv, clone at the pinned
    sha, pinned pip, the framework tree, the subject installed editable.

    The pins (``subjects/<proj>/requirements.txt`` in the work dir) are
    seeded from the repository's copy of the study's freezes when the work
    dir has none; a work-dir pin file always wins. With neither, setup
    falls back to the subject's own unpinned resolution plus the plugins'
    one runtime dependency (psutil)."""
    paths = subject_paths(subject.name)
    env = _venv_env(subject.name)

    if not os.path.exists(paths["requirements"]):
        vendored = vendored_requirements(subject.name)
        if vendored:
            os.makedirs(os.path.dirname(paths["requirements"]), exist_ok=True)
            shutil.copyfile(vendored, paths["requirements"])

    exec_fn(["virtualenv", paths["venv"]], check=True)
    exec_fn(["git", "clone", subject.url, paths["checkout"]], check=True)
    exec_fn(["git", "reset", "--hard", subject.sha], cwd=paths["checkout"],
            check=True)

    package_dir = os.path.join(paths["checkout"], subject.package_dir)
    exec_fn([*PIP_INSTALL, PIP_VERSION], env=env, check=True)
    if os.path.exists(paths["requirements"]):
        exec_fn([*PIP_INSTALL, "-r", paths["requirements"]], env=env,
                check=True)
        # testinspect's one runtime dependency must exist even when the
        # pins omit it; a pinned psutil is left untouched.
        with open(paths["requirements"]) as fd:
            pinned_psutil = any(
                line.split("==")[0].strip().lower() == "psutil"
                for line in fd
            )
        extra = [] if pinned_psutil else ["psutil"]
        exec_fn([*PIP_INSTALL, *PLUGINS, *extra, "-e", package_dir], env=env,
                check=True)
    else:
        exec_fn(["pip", "install", *PLUGINS, "psutil", "-e", package_dir],
                env=env, check=True)


def _provision_worker(subject, exec_fn=sp.run):
    # module-level so multiprocessing.Pool can pickle it
    provision_subject(subject, exec_fn=exec_fn)
    return f"provisioned: {subject.name}", subject.name


def provision_all(subjects_file=None, exec_fn=sp.run, pool_kwargs=None):
    """Provision every subject in parallel."""
    os.makedirs(CONT_DATA_DIR, exist_ok=True)
    subjects = list(iter_subjects(subjects_file) if subjects_file
                    else iter_subjects())

    worker = functools.partial(_provision_worker, exec_fn=exec_fn)
    for _ in run_pool(worker, subjects, **(pool_kwargs or {})):
        pass


def container_entrypoint(cont_name, *commands, exec_fn=sp.run):
    """The in-container verb: run the setup commands, then pytest with the
    blacklist, this package's plugins and the mode's flags."""
    proj, mode, _ = cont_name.split("_", 2)
    paths = subject_paths(proj)
    data_file = os.path.join(CONT_DATA_DIR, cont_name)
    env = _venv_env(proj)

    for cmd in commands[:-1]:
        exec_fn(shlex.split(cmd), cwd=paths["checkout"], env=env, check=True)

    pytest_cmd = [
        *shlex.split(commands[-1]), *PLUGIN_BLACKLIST, *PLUGIN_SELECT,
        "--set-exitstatus", *MODE_FLAGS[mode](data_file),
    ]
    exec_fn(pytest_cmd, timeout=CONT_TIMEOUT, cwd=paths["checkout"],
            check=True, env=env)


def docker_command(cont_name, commands, host_data_dir=None):
    host_data_dir = host_data_dir or os.path.join(os.getcwd(), DATA_DIR)
    return [
        "docker", "run", "-it", f"-v={host_data_dir}:{CONT_DATA_DIR}:rw",
        "--rm", "--init", "--cpus=1", f"--name={cont_name}", IMAGE_NAME,
        "python3", "-m", "flake16_framework_tpu_torch", "container",
        cont_name, *commands,
    ]


def launch_container(args, exec_fn=sp.run):
    """Host-side worker: ``docker run`` with stdout captured; returns the
    pool's (message, (succeeded, name)) tuple."""
    cont_name, commands = args
    stdout_file = os.path.join(STDOUT_DIR, cont_name)

    with open(stdout_file, "a") as fd:
        proc = exec_fn(docker_command(cont_name, commands), stdout=fd)

    succeeded = proc.returncode == 0
    message = "succeeded" if succeeded else "failed"
    return f"{message}: {cont_name}", (succeeded, cont_name)


def enumerate_containers(run_modes, subjects=None):
    """All (name, commands) pairs: {proj} x {mode} x {run_n}."""
    for subject in (subjects if subjects is not None else iter_subjects()):
        # sorted: set iteration order depends on the hash seed, and the
        # launch order should be the same run to run.
        for mode in sorted(set(run_modes)):
            for run_n in range(N_RUNS[mode]):
                yield f"{subject.name}_{mode}_{run_n}", subject.commands


def read_ledger(path=LOG_FILE):
    if not os.path.exists(path):
        return set()
    with open(path, "r") as fd:
        return {line.strip() for line in fd if line.strip()}


def append_ledger(cont_name, path=LOG_FILE):
    with open(path, "a") as fd:
        fd.write(f"{cont_name}\n")


def run_experiment(run_modes, subjects=None, exec_fn=sp.run, pool_kwargs=None,
                   exit_fn=sys.exit):
    """The collection campaign with resume: skip the containers in the
    ledger, append successes to it, exit 1 if anything failed."""
    os.makedirs(DATA_DIR, exist_ok=True)
    os.makedirs(STDOUT_DIR, exist_ok=True)

    done = read_ledger()
    work = [
        (name, commands)
        for name, commands in enumerate_containers(run_modes, subjects)
        if name not in done
    ]

    # partial over the module-level worker: picklable for multiprocessing
    worker = functools.partial(launch_container, exec_fn=exec_fn)

    exitstatus = 0
    for succeeded, cont_name in run_pool(worker, work, **(pool_kwargs or {})):
        if succeeded:
            append_ledger(cont_name)
        else:
            exitstatus = 1

    exit_fn(exitstatus)
