"""The plain reference that decides `correct`: NumPy and the standard
library only.  It imports nothing of the program and reads nothing the
program made: it works from the configuration's genome (portbench.gen),
the reads' origins and the SAM text the timed path yielded."""
