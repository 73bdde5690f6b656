"""The strategy search: the native cost model's binding (bindings.py), the
machine models and their calibration on the card (machine.py), the search
over the graph (search.py)."""
