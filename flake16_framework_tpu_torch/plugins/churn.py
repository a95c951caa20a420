"""Per-line git churn (a copy of the JAX package's ``plugins/churn.py``):
how many commits introduced or modified each line.

Feeds the "Covered Changes" feature (constants.FEATURE_NAMES[1]): the
collation sums, over a test's covered lines, churn[file][line]
(runner/collate.coverage_features). Line numbers refer to the file's
CURRENT numbering, so the history walk must track how every hunk shifts
lines.

Algorithm: walk ``git log --reverse -p -U0`` oldest-first, maintaining per
file a list of per-line change counts. A hunk replacing old lines
[os, os+ol) with new lines [ns, ns+nl) assigns the new lines
max(counts of the replaced lines, 0) + 1 and splices them in; untouched
lines carry their counts (and implicitly shift). Renames are treated as
delete+add (``--no-renames``) — the rename loses history, which matches the
"new file" reading of churn.
"""

import re
import subprocess

_HUNK = re.compile(
    r"^@@ -(\d+)(?:,(\d+))? \+(\d+)(?:,(\d+))? @@"
)


def _git_log(root):
    out = subprocess.run(
        ["git", "log", "--reverse", "--no-renames", "-p", "-U0",
         "--pretty=format:\x01"],
        cwd=root, capture_output=True, text=True, errors="replace",
    )
    if out.returncode != 0:
        return None
    return out.stdout


def _apply_hunks(counts, hunks):
    """counts: per-line change counts (index 0 = line 1) before the commit;
    hunks: [(old_start, old_len, new_start, new_len)]. Returns post-commit
    counts. Hunks arrive in ascending old order; build the new list in one
    forward pass."""
    new = []
    src = 0  # 0-based index into counts
    for os_, ol, ns, nl in hunks:
        # -U0 coordinates: for pure insertions (ol == 0) old_start is the
        # line AFTER which the insertion lands; otherwise it is the first
        # replaced line (1-based).
        cut = os_ if ol == 0 else os_ - 1
        new.extend(counts[src:cut])
        replaced = counts[cut:cut + ol]
        base = max(replaced, default=0)
        new.extend([base + 1] * nl)
        src = cut + ol
    new.extend(counts[src:])
    return new


def git_churn(root):
    """{relative file path: {1-based line: change count}} for the work tree
    at ``root``; None when ``root`` is not a git checkout."""
    log = _git_log(root)
    if log is None:
        return None

    state = {}

    def strip_side(raw):
        raw = raw.strip()
        if raw == "/dev/null":
            return None
        if raw.startswith('"') and raw.endswith('"'):
            # core.quotePath C-quoting: octal byte escapes inside quotes
            # (e.g. "b/caf\303\251.py"); decode to the real utf-8 path.
            raw = (raw[1:-1].encode("latin-1").decode("unicode_escape")
                   .encode("latin-1").decode("utf-8", errors="replace"))
        return raw[2:]  # strip "a/" / "b/"

    for commit in log.split("\x01"):
        minus = plus = None
        hunks = []

        def flush():
            if plus is None and minus is None:
                return
            if plus is None:          # file deleted (+++ /dev/null)
                state.pop(minus, None)
            else:
                state[plus] = _apply_hunks(state.get(plus, []), hunks)
                if minus is not None and minus != plus:
                    state.pop(minus, None)

        for line in commit.splitlines():
            if line.startswith("diff --git"):
                flush()
                minus = plus = None
                hunks = []
            elif line.startswith("--- "):
                minus = strip_side(line[4:])
            elif line.startswith("+++ "):
                plus = strip_side(line[4:])
            else:
                m = _HUNK.match(line)
                if m:
                    hunks.append((
                        int(m.group(1)),
                        int(m.group(2)) if m.group(2) is not None else 1,
                        int(m.group(3)),
                        int(m.group(4)) if m.group(4) is not None else 1,
                    ))
        flush()

    return {
        path: {i + 1: c for i, c in enumerate(counts) if c > 0}
        for path, counts in state.items()
    }
