"""torch.cuda.max_memory_allocated() over the window, reset at its start
(the held input pool included), in GiB."""


def read(r):
    return r.peak_window_bytes / 2 ** 30
