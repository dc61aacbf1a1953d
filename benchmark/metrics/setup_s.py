"""Process start to the first timed call: imports, the CUDA context, the
kernel and native libraries' loads (and builds, in a checkout's first
run), the inputs made, the warm-up over every file of the pool."""


def read(run):
    return run.setup_s
