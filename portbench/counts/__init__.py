"""The yardstick of portbench's rooflines: the peaks of the card
(`peaks.py`, with their sources) and the least work of each request
(`work.py`), counted from the algorithm at the request's shapes.
"""
