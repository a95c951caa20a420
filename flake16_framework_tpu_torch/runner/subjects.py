"""The subject registry (a copy of the JAX package's
``runner/subjects.py``): one CSV line per subject,
``owner/repo,sha,package_dir,cmd1[,cmd2...]``, the trailing commands the
in-container setup steps and the final pytest invocation; lines starting
with ``#`` are comments. The study's 26 subjects ship with the package
(``subjects.txt``); a ``subjects.txt`` in the working directory overrides
it."""

import os
from dataclasses import dataclass

from flake16_framework_tpu_torch.constants import SUBJECTS_FILE

PACKAGED_SUBJECTS_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "subjects.txt",
)


@dataclass(frozen=True)
class Subject:
    name: str          # repo name without owner (container/venv key)
    repo: str          # owner/name (GitHub path)
    sha: str           # pinned commit
    package_dir: str   # subdir pip-installed editable
    commands: tuple    # setup commands + final pytest command

    @property
    def url(self):
        return f"https://github.com/{self.repo}"


def parse_subject_line(line):
    repo, sha, package_dir, *commands = line.strip().split(",")
    return Subject(
        name=repo.split("/", 1)[1], repo=repo, sha=sha,
        package_dir=package_dir, commands=tuple(commands),
    )


def iter_subjects(path=None):
    if path is None:
        path = (SUBJECTS_FILE if os.path.exists(SUBJECTS_FILE)
                else PACKAGED_SUBJECTS_FILE)
    with open(path, "r") as fd:
        for line in fd:
            if line.strip() and not line.lstrip().startswith("#"):
                yield parse_subject_line(line)
