"""The yardstick of the kernels and the model: the card's published peaks,
and the work of one call of each kernel (and of the model's step), counted
from the call's shapes whatever variant ran."""
