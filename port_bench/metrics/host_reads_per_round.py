"""host_reads_per_round: the program's blocking reads of device values a
secure round (its ``repro_host_reads_total`` over its
``repro_rounds_total``, over every job of the run: a step fit reads once
a round and once for its beta, a path once a scan slot, block and
chunk); nothing off the card, without a traced part, where the program
has no such counter or its tracer dropped spans."""
from pbench import spans


def read(ctx):
    if not ctx.on_card or ctx.trace is None or \
            spans.program_tracer() is None:
        return None
    return spans.host_reads_per_round()
