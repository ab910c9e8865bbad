"""Seconds from the start of the process to the first timed request:
inputs, weights, the program's set-up, kernel builds and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
