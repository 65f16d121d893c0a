"""Set-up: process start to the end of the cell's warm-up (imports, weights
drawn on the card, the pipeline, the warm-up; the kernel build where the
checkout has none yet, which the result line also gives apart as
``build_s``)."""


def read(run):
    return run.setup_s
