"""Set-up seconds: process start to the window's start (imports, CUDA
initialisation, loading the kernel library and the compiled programs,
System.new, the input pool on the device, one cold job per pool input)."""


def read(r):
    return r.setup_s
