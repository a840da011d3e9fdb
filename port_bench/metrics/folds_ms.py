"""folds_ms: host ms a path in the program's ``folds`` spans (the CPU
fold draw of every institution and the fold ids' copy to the card each
chunk) over the traced paths; nothing off the card, without a traced
part, or where the program's tracer has no such span or dropped spans."""
from pbench import spans


def read(ctx):
    tracer = spans.program_tracer()
    if not ctx.on_card or ctx.trace is None or tracer is None \
            or not ctx.trace["jobs"]:
        return None
    folds = [s.duration for s in tracer.spans if s.kind == "folds"]
    return 1e3 * sum(folds) / len(ctx.trace["jobs"]) if folds else None
