"""The port's transforms; the names the JAX package's `transforms` exports."""
from .operators import (
    DerivativeHead,
    ScatteredSpatialHead,
    LinearOperatorHead,
    MixedValueHead,
    OperatorTerm,
    SpatialHead,
    StackedHead,
    StateObservation,
    STOperatorHead,
    ValueHead,
    derivative_row,
    s_grad,
    s_identity,
    s_laplacian,
)
from .inputs import UncertainInputLikelihood
