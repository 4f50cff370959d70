# -*- coding: utf-8 -*-
"""
quakemigrate_torch.coords -- map projections and geodesy, a copy of the
JAX package's ``coords`` (which the port does not import).

Native replacement for the reference's pyproj dependency (used throughout
quakemigrate/lut/lut.py for grid <-> geographic transforms). Provides a
``Proj`` factory with the same keyword style as pyproj
(``Proj(proj="lcc", units="km", lon_0=..., lat_0=..., lat_1=..., lat_2=...)``)
and a ``Transformer`` with ``.from_proj(p1, p2).transform(x, y, z)``.

Implemented projections (ellipsoidal closed forms / series, Snyder 1987):
longlat, lcc (Lambert Conformal Conic, 1SP/2SP), tmerc (Transverse
Mercator), utm, eqc (Equidistant Cylindrical / Plate Carree), aeqd
(Azimuthal Equidistant, spherical). Horizontal coordinates are scaled to the
projection's ``units`` ("m" or "km"); the vertical coordinate passes through
transforms unchanged (matching pyproj's behaviour for 2-D CRS + z).

"""

from __future__ import annotations

import numpy as np

# name -> (semi-major axis a [m], reciprocal flattening 1/f; 0 => sphere)
ELLIPSOIDS = {
    "WGS84": (6378137.0, 298.257223563),
    "GRS80": (6378137.0, 298.257222101),
    "WGS72": (6378135.0, 298.26),
    "aust_SA": (6378160.0, 298.25),
    "krass": (6378245.0, 298.3),
    "intl": (6378388.0, 297.0),
    "clrk80": (6378249.145, 293.465),
    "clrk66": (6378206.4, 294.9786982),
    "airy": (6377563.396, 299.3249646),
    "bessel": (6377397.155, 299.1528128),
    "evrst30": (6377276.345, 300.8017),
    "sphere": (6370997.0, 0.0),
}

_UNIT_FACTORS = {"m": 1.0, "metre": 1.0, "meter": 1.0, "km": 1000.0,
                 "kilometre": 1000.0, "kilometer": 1000.0}


class _AxisInfo:
    """pyproj CRS axis_info shim exposing unit metadata."""

    def __init__(self, unit_name, unit_conversion_factor):
        self.unit_name = unit_name
        self.unit_conversion_factor = unit_conversion_factor


class _CRS:
    def __init__(self, axis_info):
        self.axis_info = axis_info


class Projection:
    """Base class: forward lon/lat (deg) -> x/y in projection units."""

    name = "base"

    def __init__(self, ellps="WGS84", units="m", **params):
        self.ellps = ellps if ellps in ELLIPSOIDS else "WGS84"
        self.a, rf = ELLIPSOIDS[self.ellps]
        self.f = 0.0 if rf == 0 else 1.0 / rf
        self.e2 = self.f * (2 - self.f)
        self.e = np.sqrt(self.e2)
        units = {"kilometre": "km", "kilometer": "km", "metre": "m",
                 "meter": "m"}.get(units, units)
        self.units = units
        self.unit_factor = _UNIT_FACTORS[units]
        self.params = dict(params)
        full_name = "kilometre" if units == "km" else "metre"
        self.crs = _CRS([_AxisInfo(full_name, self.unit_factor)])

    # forward/inverse in metres; unit scaling handled by __call__ wrappers
    def _forward(self, lon, lat):
        raise NotImplementedError

    def _inverse(self, x, y):
        raise NotImplementedError

    def forward(self, lon, lat):
        x, y = self._forward(np.asarray(lon, float), np.asarray(lat, float))
        return x / self.unit_factor, y / self.unit_factor

    def inverse(self, x, y):
        return self._inverse(
            np.asarray(x, float) * self.unit_factor,
            np.asarray(y, float) * self.unit_factor,
        )

    def definition(self):
        return {
            "proj": self.name,
            "ellps": self.ellps,
            "units": self.units,
            **self.params,
        }

    def __eq__(self, other):
        return isinstance(other, Projection) and self.definition() == other.definition()

    def __hash__(self):
        return hash(tuple(sorted(self.definition().items())))

    def __repr__(self):
        params = " ".join(f"+{k}={v}" for k, v in self.definition().items())
        return f"Proj({params})"

    # pickle support via definition
    def __reduce__(self):
        return (_from_definition, (self.definition(),))


class LongLat(Projection):
    """Geographic coordinates; identity transform in degrees."""

    name = "longlat"

    def __init__(self, **params):
        params.setdefault("units", "m")
        super().__init__(
            ellps=params.pop("ellps", "WGS84"), units=params.pop("units"),
        )
        # Geographic CRS: unit is degree; ucf irrelevant but kept at 1
        self.crs = _CRS([_AxisInfo("degree", 1.0)])

    def forward(self, lon, lat):
        return np.asarray(lon, float), np.asarray(lat, float)

    def inverse(self, x, y):
        return np.asarray(x, float), np.asarray(y, float)


def _tsfn(phi, e):
    """Snyder's t(phi) for conformal projections."""

    return np.tan(np.pi / 4 - phi / 2) / (
        (1 - e * np.sin(phi)) / (1 + e * np.sin(phi))
    ) ** (e / 2)


def _msfn(phi, e2):
    return np.cos(phi) / np.sqrt(1 - e2 * np.sin(phi) ** 2)


def _phi_from_ts(ts, e, tol=1e-12, maxiter=30):
    """Invert t(phi) iteratively (Snyder 7-9)."""

    phi = np.pi / 2 - 2 * np.arctan(ts)
    for _ in range(maxiter):
        esin = e * np.sin(phi)
        new = np.pi / 2 - 2 * np.arctan(
            ts * ((1 - esin) / (1 + esin)) ** (e / 2)
        )
        if np.all(np.abs(new - phi) < tol):
            return new
        phi = new
    return phi


class LambertConformalConic(Projection):
    """Ellipsoidal LCC (1 or 2 standard parallels), Snyder 15-1..15-11."""

    name = "lcc"

    def __init__(self, lon_0=0.0, lat_0=0.0, lat_1=None, lat_2=None,
                 x_0=0.0, y_0=0.0, **kwargs):
        if lat_1 is None:
            lat_1 = lat_0
        if lat_2 is None:
            lat_2 = lat_1
        super().__init__(
            ellps=kwargs.pop("ellps", "WGS84"), units=kwargs.pop("units", "m"),
            lon_0=lon_0, lat_0=lat_0, lat_1=lat_1, lat_2=lat_2,
            x_0=x_0, y_0=y_0,
        )
        e, e2 = self.e, self.e2
        phi0, phi1, phi2 = np.deg2rad([lat_0, lat_1, lat_2])
        m1 = _msfn(phi1, e2)
        t0, t1 = _tsfn(phi0, e), _tsfn(phi1, e)
        if abs(lat_1 - lat_2) > 1e-10:
            m2 = _msfn(np.deg2rad(lat_2), e2)
            t2 = _tsfn(np.deg2rad(lat_2), e)
            self.n = np.log(m1 / m2) / np.log(t1 / t2)
        else:
            self.n = np.sin(phi1)
        if abs(self.n) < 1e-10:
            raise ValueError(
                "Lambert Conformal Conic is degenerate for standard "
                "parallels at/symmetric about the equator -- use proj='tmerc' "
                "or 'eqc' instead."
            )
        self.F = m1 / (self.n * t1**self.n)
        self.rho0 = self.a * self.F * t0**self.n
        self.lam0 = np.deg2rad(lon_0)
        self.x_0, self.y_0 = x_0, y_0

    def _forward(self, lon, lat):
        phi = np.deg2rad(lat)
        lam = np.deg2rad(lon)
        t = _tsfn(phi, self.e)
        rho = self.a * self.F * t**self.n
        # wrap to [-pi, pi] scaled by n
        theta = self.n * (np.mod(lam - self.lam0 + np.pi, 2 * np.pi) - np.pi)
        x = rho * np.sin(theta) + self.x_0
        y = self.rho0 - rho * np.cos(theta) + self.y_0
        return x, y

    def _inverse(self, x, y):
        x = x - self.x_0
        y = y - self.y_0
        rho = np.hypot(x, self.rho0 - y) * np.sign(self.n)
        theta = np.arctan2(
            np.sign(self.n) * x, np.sign(self.n) * (self.rho0 - y)
        )
        ts = (rho / (self.a * self.F)) ** (1.0 / self.n)
        phi = _phi_from_ts(ts, self.e)
        lam = theta / self.n + self.lam0
        return np.rad2deg(lam), np.rad2deg(phi)


class TransverseMercator(Projection):
    """Ellipsoidal Transverse Mercator (Snyder 8-9..8-17 series)."""

    name = "tmerc"

    def __init__(self, lon_0=0.0, lat_0=0.0, k_0=1.0, x_0=0.0, y_0=0.0,
                 **kwargs):
        k_0 = kwargs.pop("k", k_0)
        super().__init__(
            ellps=kwargs.pop("ellps", "WGS84"), units=kwargs.pop("units", "m"),
            lon_0=lon_0, lat_0=lat_0, k_0=k_0, x_0=x_0, y_0=y_0,
        )
        self.lam0 = np.deg2rad(lon_0)
        self.phi0 = np.deg2rad(lat_0)
        self.k0 = k_0
        self.x_0, self.y_0 = x_0, y_0
        e2 = self.e2
        self._mcoef = (
            1 - e2 / 4 - 3 * e2**2 / 64 - 5 * e2**3 / 256,
            3 * e2 / 8 + 3 * e2**2 / 32 + 45 * e2**3 / 1024,
            15 * e2**2 / 256 + 45 * e2**3 / 1024,
            35 * e2**3 / 3072,
        )
        self.M0 = self._meridian_dist(self.phi0)

    def _meridian_dist(self, phi):
        c0, c2, c4, c6 = self._mcoef
        return self.a * (
            c0 * phi - c2 * np.sin(2 * phi) + c4 * np.sin(4 * phi)
            - c6 * np.sin(6 * phi)
        )

    def _forward(self, lon, lat):
        phi = np.deg2rad(lat)
        lam = np.deg2rad(lon)
        e2 = self.e2
        ep2 = e2 / (1 - e2)
        N = self.a / np.sqrt(1 - e2 * np.sin(phi) ** 2)
        T = np.tan(phi) ** 2
        C = ep2 * np.cos(phi) ** 2
        A = (np.mod(lam - self.lam0 + np.pi, 2 * np.pi) - np.pi) * np.cos(phi)
        M = self._meridian_dist(phi)
        x = self.k0 * N * (
            A + (1 - T + C) * A**3 / 6
            + (5 - 18 * T + T**2 + 72 * C - 58 * ep2) * A**5 / 120
        )
        y = self.k0 * (
            M - self.M0
            + N * np.tan(phi) * (
                A**2 / 2
                + (5 - T + 9 * C + 4 * C**2) * A**4 / 24
                + (61 - 58 * T + T**2 + 600 * C - 330 * ep2) * A**6 / 720
            )
        )
        return x + self.x_0, y + self.y_0

    def _inverse(self, x, y):
        x = x - self.x_0
        y = y - self.y_0
        e2 = self.e2
        ep2 = e2 / (1 - e2)
        M = self.M0 + y / self.k0
        mu = M / (self.a * self._mcoef[0])
        e1 = (1 - np.sqrt(1 - e2)) / (1 + np.sqrt(1 - e2))
        phi1 = (
            mu
            + (3 * e1 / 2 - 27 * e1**3 / 32) * np.sin(2 * mu)
            + (21 * e1**2 / 16 - 55 * e1**4 / 32) * np.sin(4 * mu)
            + (151 * e1**3 / 96) * np.sin(6 * mu)
            + (1097 * e1**4 / 512) * np.sin(8 * mu)
        )
        C1 = ep2 * np.cos(phi1) ** 2
        T1 = np.tan(phi1) ** 2
        N1 = self.a / np.sqrt(1 - e2 * np.sin(phi1) ** 2)
        R1 = self.a * (1 - e2) / (1 - e2 * np.sin(phi1) ** 2) ** 1.5
        D = x / (N1 * self.k0)
        phi = phi1 - (N1 * np.tan(phi1) / R1) * (
            D**2 / 2
            - (5 + 3 * T1 + 10 * C1 - 4 * C1**2 - 9 * ep2) * D**4 / 24
            + (61 + 90 * T1 + 298 * C1 + 45 * T1**2 - 252 * ep2 - 3 * C1**2)
            * D**6 / 720
        )
        lam = self.lam0 + (
            D
            - (1 + 2 * T1 + C1) * D**3 / 6
            + (5 - 2 * C1 + 28 * T1 - 3 * C1**2 + 8 * ep2 + 24 * T1**2)
            * D**5 / 120
        ) / np.cos(phi1)
        return np.rad2deg(lam), np.rad2deg(phi)


class EquidistantCylindrical(Projection):
    """Plate Carree with a standard parallel (spherical; NLLoc 'SIMPLE')."""

    name = "eqc"

    def __init__(self, lon_0=0.0, lat_0=0.0, lat_ts=None, **kwargs):
        if lat_ts is None:
            lat_ts = lat_0
        super().__init__(
            ellps=kwargs.pop("ellps", "WGS84"), units=kwargs.pop("units", "m"),
            lon_0=lon_0, lat_0=lat_0, lat_ts=lat_ts,
        )
        self.lam0 = np.deg2rad(lon_0)
        self.phi0 = np.deg2rad(lat_0)
        self.cos_ts = np.cos(np.deg2rad(lat_ts))

    def _forward(self, lon, lat):
        lam = np.deg2rad(lon)
        phi = np.deg2rad(lat)
        x = self.a * (np.mod(lam - self.lam0 + np.pi, 2 * np.pi) - np.pi) * self.cos_ts
        y = self.a * (phi - self.phi0)
        return x, y

    def _inverse(self, x, y):
        lam = self.lam0 + x / (self.a * self.cos_ts)
        phi = self.phi0 + y / self.a
        return np.rad2deg(lam), np.rad2deg(phi)


class AzimuthalEquidistant(Projection):
    """Spherical azimuthal equidistant projection."""

    name = "aeqd"

    def __init__(self, lon_0=0.0, lat_0=0.0, **kwargs):
        super().__init__(
            ellps=kwargs.pop("ellps", "WGS84"), units=kwargs.pop("units", "m"),
            lon_0=lon_0, lat_0=lat_0,
        )
        self.lam0 = np.deg2rad(lon_0)
        self.phi0 = np.deg2rad(lat_0)

    def _forward(self, lon, lat):
        lam = np.deg2rad(lon)
        phi = np.deg2rad(lat)
        cosc = np.sin(self.phi0) * np.sin(phi) + np.cos(self.phi0) * np.cos(
            phi
        ) * np.cos(lam - self.lam0)
        c = np.arccos(np.clip(cosc, -1, 1))
        with np.errstate(invalid="ignore", divide="ignore"):
            k = np.where(c == 0, 1.0, c / np.sin(c))
        x = self.a * k * np.cos(phi) * np.sin(lam - self.lam0)
        y = self.a * k * (
            np.cos(self.phi0) * np.sin(phi)
            - np.sin(self.phi0) * np.cos(phi) * np.cos(lam - self.lam0)
        )
        return x, y

    def _inverse(self, x, y):
        rho = np.hypot(x, y)
        c = rho / self.a
        with np.errstate(invalid="ignore", divide="ignore"):
            phi = np.where(
                rho == 0,
                self.phi0,
                np.arcsin(
                    np.cos(c) * np.sin(self.phi0)
                    + y * np.sin(c) * np.cos(self.phi0) / np.where(rho == 0, 1, rho)
                ),
            )
            lam = self.lam0 + np.arctan2(
                x * np.sin(c),
                rho * np.cos(self.phi0) * np.cos(c)
                - y * np.sin(self.phi0) * np.sin(c),
            )
        return np.rad2deg(lam), np.rad2deg(phi)


_PROJECTIONS = {
    "longlat": LongLat,
    "latlong": LongLat,
    "lcc": LambertConformalConic,
    "tmerc": TransverseMercator,
    "eqc": EquidistantCylindrical,
    "aeqd": AzimuthalEquidistant,
}


def Proj(*args, **kwargs):
    """
    pyproj-style projection factory, e.g.::

        Proj(proj="lcc", units="km", lon_0=-17.2, lat_0=64.3,
             lat_1=64.3, lat_2=64.4, datum="WGS84", ellps="WGS84")

    ``datum`` and ``no_defs`` are accepted for call-compatibility and
    ignored (WGS84 datum is assumed). ``proj="utm"`` with ``zone=N`` (and
    optional ``south=True``) expands to the matching tmerc.

    """

    if args and isinstance(args[0], Projection):
        return args[0]
    kwargs = dict(kwargs)
    kwargs.pop("datum", None)
    kwargs.pop("no_defs", None)
    name = kwargs.pop("proj", "longlat")
    if name == "utm":
        zone = int(kwargs.pop("zone"))
        south = kwargs.pop("south", False)
        return TransverseMercator(
            lon_0=zone * 6 - 183,
            lat_0=0.0,
            k_0=0.9996,
            x_0=500000.0,
            y_0=10000000.0 if south else 0.0,
            **kwargs,
        )
    try:
        cls = _PROJECTIONS[name]
    except KeyError:
        raise NotImplementedError(f"Projection type {name} not supported.")
    return cls(**kwargs)


def _from_definition(definition):
    """Rebuild a Projection from its definition dict (pickle support)."""

    return Proj(**definition)


class Transformer:
    """Transforms coordinates between two projections (z passes through)."""

    def __init__(self, p_from, p_to):
        self.p_from = p_from
        self.p_to = p_to

    @classmethod
    def from_proj(cls, p_from, p_to):
        return cls(p_from, p_to)

    def transform(self, x, y, z=None):
        if isinstance(self.p_from, LongLat):
            lon, lat = np.asarray(x, float), np.asarray(y, float)
        else:
            lon, lat = self.p_from.inverse(x, y)
        if isinstance(self.p_to, LongLat):
            ox, oy = lon, lat
        else:
            ox, oy = self.p_to.forward(lon, lat)
        if z is None:
            return ox, oy
        return ox, oy, np.asarray(z, float)


def _great_circle_dist_azimuth(lat1, lon1, lat2, lon2, a, f):
    """Great-circle distance/azimuths on the geocentric sphere — the
    fallback for geometries where Vincenty does not converge."""

    gl1 = np.arctan((1 - f) ** 2 * np.tan(np.deg2rad(lat1)))
    gl2 = np.arctan((1 - f) ** 2 * np.tan(np.deg2rad(lat2)))
    dlon = np.deg2rad(lon2 - lon1)
    central = np.arccos(np.clip(
        np.sin(gl1) * np.sin(gl2)
        + np.cos(gl1) * np.cos(gl2) * np.cos(dlon), -1.0, 1.0,
    ))
    radius = (2 * a + a * (1 - f)) / 3  # mean Earth radius
    az = np.rad2deg(np.arctan2(
        np.sin(dlon) * np.cos(gl2),
        np.cos(gl1) * np.sin(gl2)
        - np.sin(gl1) * np.cos(gl2) * np.cos(dlon),
    )) % 360
    baz = np.rad2deg(np.arctan2(
        -np.sin(dlon) * np.cos(gl1),
        np.cos(gl2) * np.sin(gl1)
        - np.sin(gl2) * np.cos(gl1) * np.cos(dlon),
    )) % 360
    return float(radius * central), float(az), float(baz)


def gps2dist_azimuth(lat1, lon1, lat2, lon2, a=6378137.0, f=1 / 298.257223563):
    """
    Vincenty inverse geodesic: distance (m), azimuth A->B and back-azimuth
    B->A (degrees clockwise from north).

    """

    if lat1 == lat2 and lon1 == lon2:
        return 0.0, 0.0, 0.0

    b = a * (1 - f)
    u1 = np.arctan((1 - f) * np.tan(np.deg2rad(lat1)))
    u2 = np.arctan((1 - f) * np.tan(np.deg2rad(lat2)))
    ell = np.deg2rad(lon2 - lon1)
    lam = ell
    sin_u1, cos_u1 = np.sin(u1), np.cos(u1)
    sin_u2, cos_u2 = np.sin(u2), np.cos(u2)

    converged = False
    for _ in range(200):
        sin_lam, cos_lam = np.sin(lam), np.cos(lam)
        sin_sigma = np.sqrt(
            (cos_u2 * sin_lam) ** 2
            + (cos_u1 * sin_u2 - sin_u1 * cos_u2 * cos_lam) ** 2
        )
        if sin_sigma == 0:
            return 0.0, 0.0, 0.0
        cos_sigma = sin_u1 * sin_u2 + cos_u1 * cos_u2 * cos_lam
        sigma = np.arctan2(sin_sigma, cos_sigma)
        sin_alpha = cos_u1 * cos_u2 * sin_lam / sin_sigma
        cos2_alpha = 1 - sin_alpha**2
        if cos2_alpha == 0:  # equatorial line
            cos_2sigma_m = 0.0
        else:
            cos_2sigma_m = cos_sigma - 2 * sin_u1 * sin_u2 / cos2_alpha
        C = f / 16 * cos2_alpha * (4 + f * (4 - 3 * cos2_alpha))
        lam_prev = lam
        lam = ell + (1 - C) * f * sin_alpha * (
            sigma
            + C * sin_sigma * (
                cos_2sigma_m + C * cos_sigma * (-1 + 2 * cos_2sigma_m**2)
            )
        )
        if abs(lam - lam_prev) < 1e-12:
            converged = True
            break

    if not converged:
        # Nearly antipodal points: Vincenty's lambda iteration diverges,
        # and the non-converged solution can be off by many km. Fall back
        # to a great-circle solve on the geocentric sphere instead of
        # returning it silently (the same strategy the ObsPy function
        # this replaces uses).
        return _great_circle_dist_azimuth(lat1, lon1, lat2, lon2, a, f)

    u_sq = cos2_alpha * (a**2 - b**2) / b**2
    A = 1 + u_sq / 16384 * (4096 + u_sq * (-768 + u_sq * (320 - 175 * u_sq)))
    B = u_sq / 1024 * (256 + u_sq * (-128 + u_sq * (74 - 47 * u_sq)))
    delta_sigma = B * sin_sigma * (
        cos_2sigma_m
        + B / 4 * (
            cos_sigma * (-1 + 2 * cos_2sigma_m**2)
            - B / 6 * cos_2sigma_m * (-3 + 4 * sin_sigma**2)
            * (-3 + 4 * cos_2sigma_m**2)
        )
    )
    dist = b * A * (sigma - delta_sigma)

    alpha1 = np.arctan2(
        cos_u2 * np.sin(lam), cos_u1 * sin_u2 - sin_u1 * cos_u2 * np.cos(lam)
    )
    alpha2 = np.arctan2(
        cos_u1 * np.sin(lam), -sin_u1 * cos_u2 + cos_u1 * sin_u2 * np.cos(lam)
    )
    az = np.rad2deg(alpha1) % 360
    baz = (np.rad2deg(alpha2) + 180) % 360

    return float(dist), float(az), float(baz)
