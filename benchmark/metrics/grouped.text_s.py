"""Seconds a build of the grouped tier's text stage (the text's codes
uploaded once and packed 2 bits a code on the card): the program's span
debwt.grouped.text."""

from benchmark.measure.program import stage_seconds


def read(w):
    return stage_seconds(w, "debwt.grouped.text")
