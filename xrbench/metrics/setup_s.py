"""Seconds from the process's start to the window's: imports, kernel
builds or loads, the weights drawn on the card, one warm-up batch."""


def read(run):
    return run["setup_s"]
