"""Demo-site generator (counterpart of knnsvc_tpu/eval/demo_site.py; ref
demo_site_template.py): builds a static index.html of audio comparison
tables (src / ref / converted variants, duration-ablation grids) with
inline <audio> players.

Clean re-implementation of the reference's table builder: give it rows of
(label, audio path) cells; audio paths become players, strings become text
cells. `sync_to_server` mirrors the reference's rsync publish step."""

from __future__ import annotations

import html
import shutil
import subprocess
from pathlib import Path

_PAGE_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
  <meta http-equiv="content-type" content="text/html; charset=UTF-8">
  <title>{title}</title>
  <style>
    body {{ font-family: sans-serif; margin: 2em; }}
    table {{ border-collapse: collapse; margin-bottom: 2em; }}
    th, td {{ border: 1px solid #ccc; padding: 6px 10px; text-align: center; }}
    th {{ background: #f0f0f0; }}
    audio {{ width: 220px; }}
    h2 {{ margin-top: 2em; }}
  </style>
</head>
<body>
<h1>{title}</h1>
{body}
</body>
</html>
"""

_AUDIO_EXTS = {".wav", ".mp3", ".flac", ".ogg"}


def _cell(item: str, site_root: Path, assets_dir: str, copy_assets: bool) -> str:
    p = Path(item)
    if p.suffix.lower() in _AUDIO_EXTS:
        if copy_assets and p.is_file():
            dest = site_root / assets_dir / p.name
            dest.parent.mkdir(parents=True, exist_ok=True)
            if not dest.exists():
                shutil.copy2(p, dest)
            rel = f"{assets_dir}/{p.name}"
        else:
            rel = str(item)
        return f'<audio controls preload="none" src="{html.escape(rel)}"></audio>'
    return html.escape(str(item))


def table_html(cells: list, num_cols: int, header_first_row: bool,
               site_root: Path, assets_dir: str = "assets",
               copy_assets: bool = True) -> str:
    """Flat cell list -> <table> with num_cols columns
    (ref demo_site_template.py:104-152)."""
    rows = [cells[i : i + num_cols] for i in range(0, len(cells), num_cols)]
    out = ["<table>"]
    for r, row in enumerate(rows):
        out.append("<tr>")
        for item in row:
            tag = "th" if (header_first_row and r == 0) else "td"
            out.append(f"<{tag}>{_cell(item, site_root, assets_dir, copy_assets)}</{tag}>")
        out.append("</tr>")
    out.append("</table>")
    return "".join(out)


def build_demo_page(sections: list[tuple[str, list, int]], output_dir: str,
                    title: str = "kNN-SVC demo", copy_assets: bool = True) -> str:
    """sections: list of (heading, flat cell list, num_cols). Writes
    index.html (+ copied audio under assets/) to output_dir; returns its path."""
    site_root = Path(output_dir)
    site_root.mkdir(parents=True, exist_ok=True)
    body = []
    for heading, cells, num_cols in sections:
        body.append(f"<h2>{html.escape(heading)}</h2>")
        body.append(table_html(cells, num_cols, header_first_row=True,
                               site_root=site_root, copy_assets=copy_assets))
    page = _PAGE_TEMPLATE.format(title=html.escape(title), body="\n".join(body))
    out = site_root / "index.html"
    out.write_text(page)
    return str(out)


def sync_to_server(output_dir: str, remote: str) -> None:
    """rsync the site to a remote (ref demo_site_template.py publish step)."""
    subprocess.run(["rsync", "-az", str(output_dir).rstrip("/") + "/", remote], check=True)


def duration_ablation_section(src: str, ref: str, converted_by_duration: dict[str, str],
                              heading: str = "reference-pool duration ablation"):
    """The reference's {5,10,30,60,90,full} grid (ref :284-299,
    old_README.md:42) as a section tuple for build_demo_page."""
    cols = ["", "src", "ref"] + list(converted_by_duration.keys())
    row = ["knn-svc", src, ref] + list(converted_by_duration.values())
    return (heading, cols + row, len(cols))
