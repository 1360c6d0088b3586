"""Minimal single-sheet xlsx writer (stdlib ``zipfile`` + XML only) and the
11-column detection export (`Detect_OBB.py:326-330`)."""

from __future__ import annotations

import zipfile
from xml.sax.saxutils import escape

import numpy as np

from ..config import CLASS_NAMES

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WB_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""

XLSX_HEADER = ["Class", "X1", "Y1", "X2", "Y2", "X3", "Y3", "X4", "Y4",
               "Confidence", "Angle"]


def _col_letter(i: int) -> str:
    s = ""
    i += 1
    while i:
        i, r = divmod(i - 1, 26)
        s = chr(65 + r) + s
    return s


def _cell_xml(ref: str, value) -> str:
    if isinstance(value, str):
        return (f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">'
                f"{escape(value)}</t></is></c>")
    return f'<c r="{ref}"><v>{value!r}</v></c>'


def write_xlsx(path: str, rows: list, header: list) -> None:
    """Write a header and rows (lists of str/float) to a one-sheet xlsx."""
    body = []
    for ri, row in enumerate([header] + [list(r) for r in rows], start=1):
        cells = "".join(_cell_xml(f"{_col_letter(ci)}{ri}", v)
                        for ci, v in enumerate(row))
        body.append(f'<row r="{ri}">{cells}</row>')
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main"><sheetData>'
        + "".join(body) + "</sheetData></worksheet>"
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WB_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)


def export_xlsx(path: str, dets: np.ndarray) -> None:
    """[N, 11] detection rows -> the 11-column sheet (class name, corners,
    confidence, Strike angle)."""
    rows = []
    for r in np.asarray(dets, np.float64).reshape(-1, 11):
        cls_id = int(r[8])
        rows.append([CLASS_NAMES.get(cls_id, f"Class{cls_id}")]
                    + [float(v) for v in r[:8]]
                    + [float(r[9]), float(r[10])])
    write_xlsx(path, rows, XLSX_HEADER)
