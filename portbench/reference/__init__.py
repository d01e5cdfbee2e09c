"""The plain reference, one file for each op family: ``<op>.py`` holds the
family's input rule, reference, control (the reference one precision below
the configuration's), the number its answers are compared by with that
number's limit, and its bytes and operations. An op family is found by its
name, so a new one is a new file."""

import importlib


def family(op: str):
    return importlib.import_module(f"portbench.reference.{op}")
