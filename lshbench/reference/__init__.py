"""The plain reference that decides `correct`: torch operations only, no
import of the program (`repro_torch`) or of the JAX package."""
