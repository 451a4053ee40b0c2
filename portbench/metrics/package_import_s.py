"""package_import_s: seconds of the set-up span ``import`` that the port
keeps in memory (``simplestereo_tpu_torch.profiling.setup_spans``): the
package's ``__init__`` from its first statement to its last, with
``torch`` already loaded by the harness. The only span that no profiler
sees, since none runs at import. None where the program keeps no such
span, or, as every per-layer reader, where the traced calls ran nothing
on the device."""

import sys


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    profiling = sys.modules.get("simplestereo_tpu_torch.profiling")
    setup_spans = getattr(profiling, "setup_spans", None)
    if setup_spans is None:
        return None
    found = [end - start for name, start, end in setup_spans()
             if name == "import"]
    return found[0] if found else None
