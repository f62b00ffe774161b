"""The best masked-MSE energy that the timed path holds when the window
ends, as its objective scored it: the GA state's best fitness, or the
energy of the genome Adam ends with, as the window's block scores it in
its next step (the check recomputes both with the reference)."""


def read(rec):
    return rec.best_mse_end
