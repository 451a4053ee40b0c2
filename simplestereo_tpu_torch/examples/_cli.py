"""The command-line option every example adds to the JAX script's."""

import sys

# Where the JAX package's examples and tests read the reference's resources
# (not part of the repository); the scripts that need them default to it.
REFERENCE_RES = "/root/reference/examples/res"


def device_arg(default="cuda"):
    """Take ``--device X`` (or ``--device=X``) out of ``sys.argv``, so the
    script's positional arguments read as in the JAX script, and return X
    (``default`` when absent)."""
    argv = sys.argv
    for i, a in enumerate(argv):
        if a == "--device" and i + 1 < len(argv):
            value = argv[i + 1]
            del argv[i:i + 2]
            return value
        if a.startswith("--device="):
            del argv[i]
            return a.split("=", 1)[1]
    return default
