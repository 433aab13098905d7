"""Set-up seconds: from the process's start to the window's, imports,
kernel builds, the program's construction and the warm-up calls included."""


def read(w) -> float:
    return w.setup_s
