# Experiment container image for the TPU-native Flake16 framework (L1,
# SURVEY.md §1): builds the `flake16framework` image that
# runner/containers.docker_command launches 26x5,001 times, each container
# running
#
#     python3 -m flake16_framework_tpu container <name> <commands...>
#
# Layout inside the image (constants.py): the framework source tree at
# /home/user/framework (installed with --no-deps into every subject venv —
# it carries both pytest plugins via pyproject entry points), subject venvs +
# checkouts under /home/user/subjects, collected artifacts bind-mounted at
# /home/user/data.
#
# Per-subject dependency pins (subjects/<proj>/requirements.txt — a pip
# freeze of the resolved env at the subject's pinned SHA): the repo vendors
# the study's 26 freezes, and the COPY below places them straight into the
# image's SUBJECTS_DIR, so setup runs pinned by default; replace a
# subject's file before building (or in the work dir at run time — it
# wins) to re-freeze, and setup falls back to unpinned resolution only
# when a subject has no pins at all (runner/containers.provision_subject;
# caveat: the vendored freezes resolved on the study's py3.8 image — see
# subjects/README.md).
#
# Base: noble (Python 3.12). The testinspect plugin traces coverage via
# sys.monitoring (PEP 669, 3.12+) instead of bundling coverage.py into every
# subject venv, so subject venvs need a 3.12 interpreter; per-subject pins
# must be resolved against it (the original study's focal-era pins predate
# this and would need re-resolving regardless of framework).

FROM ubuntu:noble

ARG DEBIAN_FRONTEND=noninteractive

# Toolchain + native headers the 26 subjects' builds need (subjects.txt):
# scientific stack (BLAS/LAPACK), imaging (Pillow/scikit-image/fonttools),
# crypto + ledger (electrum), DB clients (airflow/celery), JDK (conan tests).
RUN apt-get update && apt-get install -y --no-install-recommends \
    build-essential \
    cmake \
    git \
    pkg-config \
    default-jdk \
    python3 \
    python3-dev \
    python3-pip \
    python3-tk \
    virtualenv \
    libcurl4-openssl-dev \
    libssl-dev \
    libkrb5-dev \
    libldap2-dev \
    libsasl2-dev \
    libfreetype6-dev \
    libfribidi-dev \
    libharfbuzz-dev \
    libjpeg-turbo8-dev \
    liblcms2-dev \
    libopenjp2-7-dev \
    libtiff-dev \
    libwebp-dev \
    libxcb1-dev \
    tcl8.6-dev \
    tk8.6-dev \
    zlib1g-dev \
    liblapack-dev \
    libopenblas-dev \
    libmysqlclient-dev \
    libpq-dev \
    unixodbc-dev \
    libsecp256k1-dev \
    libsndfile1-dev \
    && rm -rf /var/lib/apt/lists/*

RUN useradd -ms /bin/bash user

USER user

WORKDIR /home/user

# The framework source tree (includes the packaged subjects.txt registry and
# both pytest plugins). Installed editable-style into subject venvs by setup.
COPY --chown=user pyproject.toml framework/
COPY --chown=user flake16_framework_tpu framework/flake16_framework_tpu
# The PyTorch port, whose `run` launches `python3 -m flake16_framework_tpu_torch container` here.
COPY --chown=user flake16_framework_tpu_torch framework/flake16_framework_tpu_torch

# Optional per-subject pins (see header). The directory may be empty.
COPY --chown=user subjects subjects

# The host CLI inside the image: provision all 26 subject venvs. The
# framework itself is importable straight from the source tree (the L1/L2
# verbs are stdlib-only; the jax stack is only imported by scores/shap,
# which run on the TPU host, not in containers).
ENV PYTHONPATH=/home/user/framework
RUN python3 -m flake16_framework_tpu setup
