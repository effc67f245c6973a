"""Share of the traced window in which the card was idle while a span of
the program was open, in percent (`spans.py`): the program's own idle.
`idle_share` less this is the benchmark loop's idle between units."""

import spans


def read(r):
    return spans.program_idle_share(r)
