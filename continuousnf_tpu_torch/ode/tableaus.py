"""Butcher tableaus for explicit Runge-Kutta methods (pure data).

Port of `continuousnf_tpu/ode/tableaus.py`: the same coefficients (Tsitouras
2011 for Tsit5, Dormand-Prince 1980 for Dopri5, Bogacki-Shampine 1989 for
Bosh3, Hairer-Norsett-Wanner for Dop853, Verner 1978 for the 6(5) pair).
The implicit TR-BDF2 tableau is not ported yet (ROADMAP queue 1, item 17).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    """Explicit RK tableau.

    a:       strictly-lower-triangular stage coefficients, row i has i entries.
    b:       solution weights (order `order`).
    btilde:  b - bhat, weights of the embedded error estimate (None -> no
             error estimate; fixed-step only).
    c:       stage times.
    order:   order of the propagating solution (used by the step controller).
    fsal:    first-same-as-last (stage s of an accepted step is f at the new
             point, reusable as stage 1 of the next step).
    """

    name: str
    a: Tuple[Tuple[float, ...], ...]
    b: Tuple[float, ...]
    btilde: Optional[Tuple[float, ...]]
    c: Tuple[float, ...]
    order: int
    fsal: bool
    # Optional secondary (3rd-order) error weights for Hairer's stretched
    # 5(3) error estimate (Dop853): eest = e5^2 / sqrt(e5^2 + 0.01*e3^2).
    btilde3: Optional[Tuple[float, ...]] = None

    @property
    def num_stages(self) -> int:
        return len(self.b)


EULER = ButcherTableau(
    name="euler",
    a=((),),
    b=(1.0,),
    btilde=None,
    c=(0.0,),
    order=1,
    fsal=False,
)

MIDPOINT = ButcherTableau(
    name="midpoint",
    a=((), (0.5,)),
    b=(0.0, 1.0),
    btilde=None,
    c=(0.0, 0.5),
    order=2,
    fsal=False,
)

RK4 = ButcherTableau(
    name="rk4",
    a=((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
    b=(1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0),
    btilde=None,
    c=(0.0, 0.5, 0.5, 1.0),
    order=4,
    fsal=False,
)

BOSH3 = ButcherTableau(
    name="bosh3",
    a=(
        (),
        (1.0 / 2.0,),
        (0.0, 3.0 / 4.0),
        (2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0),
    ),
    b=(2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0, 0.0),
    btilde=(
        2.0 / 9.0 - 7.0 / 24.0,
        1.0 / 3.0 - 1.0 / 4.0,
        4.0 / 9.0 - 1.0 / 3.0,
        -1.0 / 8.0,
    ),
    c=(0.0, 0.5, 0.75, 1.0),
    order=3,
    fsal=True,
)

DOPRI5 = ButcherTableau(
    name="dopri5",
    a=(
        (),
        (1.0 / 5.0,),
        (3.0 / 40.0, 9.0 / 40.0),
        (44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0),
        (19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0),
        (9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0, -5103.0 / 18656.0),
        (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0, 11.0 / 84.0),
    ),
    b=(35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0, 11.0 / 84.0, 0.0),
    btilde=(
        71.0 / 57600.0,
        0.0,
        -71.0 / 16695.0,
        71.0 / 1920.0,
        -17253.0 / 339200.0,
        22.0 / 525.0,
        -1.0 / 40.0,
    ),
    c=(0.0, 1.0 / 5.0, 3.0 / 10.0, 4.0 / 5.0, 8.0 / 9.0, 1.0, 1.0),
    order=5,
    fsal=True,
)

TSIT5 = ButcherTableau(
    name="tsit5",
    a=(
        (),
        (0.161,),
        (-0.008480655492356989, 0.335480655492357),
        (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
        (5.325864828439257, -11.748883564062828, 7.4955393428898365, -0.09249506636175525),
        (
            5.86145544294642,
            -12.92096931784711,
            8.159367898576159,
            -0.071584973281401,
            -0.028269050394068383,
        ),
        (
            0.09646076681806523,
            0.01,
            0.4798896504144996,
            1.379008574103742,
            -3.290069515436081,
            2.324710524099774,
        ),
    ),
    b=(
        0.09646076681806523,
        0.01,
        0.4798896504144996,
        1.379008574103742,
        -3.290069515436081,
        2.324710524099774,
        0.0,
    ),
    btilde=(
        -0.00178001105222577714,
        -0.0008164344596567469,
        0.007880878010261995,
        -0.1447110071732629,
        0.5823571654525552,
        -0.45808210592918697,
        0.015151515151515152,
    ),
    c=(0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0),
    order=5,
    fsal=True,
)


# Hairer's 8(5,3) "DOP853" method (Hairer, Norsett & Wanner, Solving ODEs I,
# 2nd ed., via the dop853.f reference implementation; coefficient values
# machine-extracted from scipy.integrate's validated copy).  Represented as
# 13 stages: stage 13 evaluates f at the new point with the propagation
# weights (FSAL), feeding the embedded 5th/3rd-order error pair
# (btilde/btilde3, combined with Hairer's stretch formula in the controller).
DOP853 = ButcherTableau(
    name="dop853",
    a=(
        (),
        (0.05260015195876773,),
        (0.0197250569845379, 0.0591751709536137),
        (0.02958758547680685, 0.0, 0.08876275643042054),
        (0.2413651341592667, 0.0, -0.8845494793282861, 0.924834003261792),
        (0.037037037037037035, 0.0, 0.0, 0.17082860872947386, 0.12546768756682242),
        (0.037109375, 0.0, 0.0, 0.17025221101954405, 0.06021653898045596, -0.017578125),
        (0.03709200011850479, 0.0, 0.0, 0.17038392571223998, 0.10726203044637328, -0.015319437748624402, 0.008273789163814023),
        (0.6241109587160757, 0.0, 0.0, -3.3608926294469414, -0.868219346841726, 27.59209969944671, 20.154067550477894, -43.48988418106996),
        (0.47766253643826434, 0.0, 0.0, -2.4881146199716677, -0.590290826836843, 21.230051448181193, 15.279233632882423, -33.28821096898486, -0.020331201708508627),
        (-0.9371424300859873, 0.0, 0.0, 5.186372428844064, 1.0914373489967295, -8.149787010746927, -18.52006565999696, 22.739487099350505, 2.4936055526796523, -3.0467644718982196),
        (2.273310147516538, 0.0, 0.0, -10.53449546673725, -2.0008720582248625, -17.9589318631188, 27.94888452941996, -2.8589982771350235, -8.87285693353063, 12.360567175794303, 0.6433927460157636),
        (0.054293734116568765, 0.0, 0.0, 0.0, 0.0, 4.450312892752409, 1.8915178993145003, -5.801203960010585, 0.3111643669578199, -0.1521609496625161, 0.20136540080403034, 0.04471061572777259),
    ),
    b=(0.054293734116568765, 0.0, 0.0, 0.0, 0.0, 4.450312892752409, 1.8915178993145003, -5.801203960010585, 0.3111643669578199, -0.1521609496625161, 0.20136540080403034, 0.04471061572777259, 0.0),
    btilde=(0.01312004499419488, 0.0, 0.0, 0.0, 0.0, -1.2251564463762044, -0.4957589496572502, 1.6643771824549864, -0.35032884874997366, 0.3341791187130175, 0.08192320648511571, -0.022355307863886294, 0.0),
    btilde3=(-0.18980075407240762, 0.0, 0.0, 0.0, 0.0, 4.450312892752409, 1.8915178993145003, -5.801203960010585, -0.4226823213237919, -0.1521609496625161, 0.20136540080403034, 0.02265179219836082, 0.0),
    c=(0.0, 0.05260015195876773, 0.0789002279381516, 0.1183503419072274, 0.2816496580927726, 0.3333333333333333, 0.25, 0.3076923076923077, 0.6512820512820513, 0.6, 0.8571428571428571, 1.0, 1.0),
    order=8,
    fsal=True,
)


# Verner's 1978 efficient 6(5) embedded pair (the "DVERK" method; J.H.
# Verner, "Explicit Runge-Kutta methods with estimates of the local
# truncation error", SIAM J. Numer. Anal. 15, 1978).  Exact rational
# coefficients (floats below are the correctly-rounded values).  Fills the
# Vern7 role of Julia's `DefaultODEAlgorithm` at tight tolerances.
VERNER65 = ButcherTableau(
    name="verner65",
    a=(
        (),
        (0.16666666666666666,),
        (0.05333333333333334, 0.21333333333333335),
        (0.8333333333333334, -2.6666666666666665, 2.5),
        (-2.578125, 9.166666666666666, -6.640625, 0.8854166666666666),
        (2.4, -8.0, 6.560457516339869, -0.3055555555555556, 0.34509803921568627),
        (-0.5508666666666666, 1.6533333333333333, -0.9455882352941176, -0.324, 0.23378823529411766, 0.0),
        (2.03546511627907, -6.976744186046512, 5.648179814561484, -0.13738156761412576, 0.2863022661036103, 0.0, 0.1441785567164738),
    ),
    b=(0.075, 0.0, 0.3899286987522282, 0.3194444444444444, 0.1350383631713555, 0.0, 0.010783298826777088, 0.0698051948051948),
    btilde=(-0.00625, 0.0, -0.00696301247771836, 0.006944444444444444, -0.006138107416879796, -0.06818181818181818, 0.010783298826777088, 0.0698051948051948),
    c=(0.0, 0.16666666666666666, 0.26666666666666666, 0.6666666666666666, 0.8333333333333334, 1.0, 0.06666666666666667, 1.0),
    order=6,
    fsal=False,
)


def select_method(rtol: float) -> str:
    """The "auto" heuristic: Tsit5 at working tolerances, the 6th-order
    Verner pair at tight tolerances, Dop853 for very tight requests."""
    if rtol > 5.0e-4:
        return "tsit5"
    if rtol >= 1.0e-7:
        return "verner65"
    return "dop853"


def get_tableau(method: str, rtol: float) -> ButcherTableau:
    """Resolve a SolverOptions.method string ("auto" picks by rtol)."""
    if method == "auto":
        method = select_method(rtol)
    if method == "trbdf2":
        raise NotImplementedError(
            "the implicit TR-BDF2 solver is not ported yet (ROADMAP queue 1, item 17)"
        )
    return TABLEAUS[method]


TABLEAUS = {
    "euler": EULER,
    "midpoint": MIDPOINT,
    "rk4": RK4,
    "bosh3": BOSH3,
    "dopri5": DOPRI5,
    "tsit5": TSIT5,
    "verner65": VERNER65,
    "dop853": DOP853,
}

__all__ = ["ButcherTableau", "TABLEAUS", "EULER", "MIDPOINT", "RK4", "BOSH3", "DOPRI5", "TSIT5", "VERNER65", "DOP853", "select_method", "get_tableau"]
