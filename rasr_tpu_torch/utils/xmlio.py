"""XML input with transparent gzip decompression.

The reference's XML layer reads compressed streams everywhere (ref:
src/Core/XmlParser.* over Core compressed streams — corpora and lexica
ship as .xml.gz routinely); mirror that for every XML artifact here.
"""

from __future__ import annotations

import gzip
import xml.etree.ElementTree as ET


def parse_xml(path: str) -> ET.ElementTree:
    """ET.parse with transparent .gz handling."""
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as fh:
            return ET.parse(fh)
    return ET.parse(path)
