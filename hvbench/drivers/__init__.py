"""One driver a kind of traffic: it builds the cell's system from its
configuration, sends one call at a time, keeps the answers the seeded
sample asks for, and judges them against `hvbench.reference`.

A traffic mix names its driver by the key `driver`; the harness imports
`hvbench.drivers.<driver>`, whose `Driver` and `judge` do the rest.
"""
