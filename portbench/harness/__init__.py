"""The general part of portbench: manifest loading, the closed loop, the
trace's reduction and the run of one cell (`cell.run_cell`)."""
