"""The port's chat templates (eagle_tpu_torch/server/chat_templates.py)
against the reference's (eagle_tpu/server/chat_templates.py) on the CPU:
every family of `TEMPLATES` renders the reference's conversation as the
reference does (with and without the assistant prompt, and through
`format_single`), `detect_template` classifies every template source of
tests/test_chat_templates.py as the reference does, and executing the
embedded jinja source raises, naming its ROADMAP item."""

import pytest

import eagle_tpu.server.chat_templates as ref
import eagle_tpu_torch.server.chat_templates as port
from test_chat_templates import CASES, CONV

SOURCES = [c[2] for c in CASES] + [None, "", "{{ some novel template }}", *ref.TEMPLATES]


@pytest.mark.parametrize("family", list(ref.TEMPLATES))
def test_family_renders_as_reference(family):
    assert set(port.TEMPLATES) == set(ref.TEMPLATES)
    for add in (True, False):
        for conv in (CONV, CONV[:2], CONV[1:4]):
            assert port.apply_template(conv, template=family, add_assistant=add) == \
                ref.apply_template(conv, template=family, add_assistant=add)
    for past, new in ((CONV[:3], CONV[3]), ([], CONV[0])):
        assert port.format_single(past, new, template=family) == \
            ref.format_single(past, new, template=family)


@pytest.mark.parametrize("src", SOURCES, ids=range(len(SOURCES)))
def test_detect_template_as_reference(src):
    assert port.detect_template(src) == ref.detect_template(src)
    assert port.apply_template(CONV, jinja_src=src) == ref.apply_template(CONV, jinja_src=src)


def test_jinja_is_refused_with_its_item():
    with pytest.raises(NotImplementedError, match="jinja2 is not among"):
        port.apply_template(CONV, jinja_src=CASES[0][2], use_jinja=True)
    with pytest.raises(NotImplementedError, match="jinja2 is not among"):
        port.render_jinja(CASES[0][2], CONV)
