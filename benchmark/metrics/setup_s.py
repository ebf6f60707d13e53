"""setup_s: process start to the window's start (host clock): imports,
CUDA, the libraries' build or stamp-load, the scenes, the mix's set-up
and its warm job."""


def read(run):
    return run.setup_s
