"""setup_s: seconds from the process's start (the first statement of
``run.py``) to the first timed iteration: imports, the CUDA context, the
kernels' libraries (built on a checkout's first run), ``trainer.init`` and
the set-up iterations (eager sweep; capture and replay; replay)."""


def read(view):
    return view.setup_s
