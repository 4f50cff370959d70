# -*- coding: utf-8 -*-
"""
quakemigrate_torch.export -- export of a run's located events to other
formats: QuakeML (ObsPy-compatible), NonLinLoc OBS phase files, Snuffler
station and marker files and MFAST SAC files; the port of the JAX
package's ``export`` without pandas (the files are read back as
:class:`~quakemigrate_torch.io.table.Table`\\ s).

"""

from .catalog import EventRecord, read_run  # noqa: F401
from .to_quakeml import read_quakemigrate, write_quakeml  # noqa: F401
from .to_nlloc import nlloc_obs  # noqa: F401
from .to_snuffler import snuffler_markers, snuffler_stations  # noqa: F401
from .to_mfast import sac_mfast  # noqa: F401
