"""How the check picks a recovered slot's crop among the searched ones
(``check.pick_crop``): the best fit of the slot's joints, with crops that
fit as well as it up to ``check.TIE`` going to the one nearest the
reference's box."""

import pytest
import torch


def _gaps(**at):
    """Joint gaps over the check's search grid: 5.0 everywhere, and the
    given value at each named shift ``x_y`` (``m`` for minus)."""
    from portbench import check

    r = torch.arange(-check.SEARCH, check.SEARCH + 1, dtype=torch.float64)
    shifts = torch.cartesian_prod(r, r)
    g = torch.full((1, len(shifts)), 5.0, dtype=torch.float64)
    for name, value in at.items():
        x, y = (-int(v[1:]) if v[0] == "m" else int(v)
                for v in name.split("_"))
        g[0, ((shifts[:, 0] == x) & (shifts[:, 1] == y)).nonzero()[0, 0]] = value
    return g, shifts


@pytest.mark.parametrize("gaps, want", [
    # a tie at nought, with the search's first crop among it, is the box's
    ({"m2_m2": 0.0, "0_0": 0.0, "1_0": 0.0}, (0, 0)),
    # a crop that fits better by less than TIE loses to the box's
    ({"0_1": 0.0, "0_0": 0.03}, (0, 0)),
    # one that fits better by more wins
    ({"1_0": 0.0, "0_0": 0.2}, (1, 0)),
    # of two as near, the better fit
    ({"1_0": 0.04, "0_1": 0.01, "0_0": 3.0}, (0, 1)),
])
def test_a_slot_takes_the_nearest_of_the_crops_that_fit_alike(gaps, want):
    from portbench import check

    g, shifts = _gaps(**gaps)
    assert tuple(shifts[check.pick_crop(g, shifts)[0]].tolist()) == want
