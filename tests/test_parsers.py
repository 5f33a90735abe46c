from pathlib import Path

import numpy as np
import pytest

from multimodal_rare_disease.config import resolve_config
from multimodal_rare_disease.data.parsers import (
    HPOParser,
    OrphadataParser,
    create_syndrome_text_mapping,
    load_fgdd,
)

FGDD_DIR = Path("/root/reference/data/FGDD")

ORPHA_DISEASES = """<?xml version="1.0"?>
<JDBOR>
 <DisorderList>
  <Disorder><OrphaCode>199</OrphaCode><Name>Cornelia de Lange syndrome</Name>
   <SummaryInformation><Definition>A rare developmental disorder.</Definition></SummaryInformation>
  </Disorder>
  <Disorder><OrphaCode>904</OrphaCode><Name>Williams syndrome</Name></Disorder>
 </DisorderList>
</JDBOR>"""

ORPHA_PHENO = """<?xml version="1.0"?>
<JDBOR>
 <DisorderList>
  <Disorder><OrphaCode>199</OrphaCode>
   <HPODisorderAssociationList>
    <HPODisorderAssociation>
     <HPO><HPOId>HP:0000664</HPOId><HPOTerm>Synophrys</HPOTerm></HPO>
    </HPODisorderAssociation>
    <HPODisorderAssociation>
     <HPO><HPOId>HP:0000527</HPOId><HPOTerm>Long eyelashes</HPOTerm></HPO>
    </HPODisorderAssociation>
   </HPODisorderAssociationList>
  </Disorder>
 </DisorderList>
</JDBOR>"""

ORPHA_GENES = """<?xml version="1.0"?>
<JDBOR>
 <DisorderList>
  <Disorder><OrphaCode>199</OrphaCode>
   <DisorderGeneAssociationList>
    <DisorderGeneAssociation>
     <Gene><Symbol>NIPBL</Symbol><Name>NIPBL cohesin loading factor</Name></Gene>
    </DisorderGeneAssociation>
   </DisorderGeneAssociationList>
  </Disorder>
 </DisorderList>
</JDBOR>"""

HPO_OBO = """format-version: 1.2

[Term]
id: HP:0000664
name: Synophrys
def: "Meeting of the eyebrows in the midline." [PMID:1]
is_a: HP:0000534 ! Abnormal eyebrow

[Term]
id: HP:0000527
name: Long eyelashes
is_a: HP:0000499 ! Abnormal eyelash
"""


@pytest.fixture
def orpha(tmp_path):
    d = tmp_path / "d.xml"
    p = tmp_path / "p.xml"
    g = tmp_path / "g.xml"
    d.write_text(ORPHA_DISEASES)
    p.write_text(ORPHA_PHENO)
    g.write_text(ORPHA_GENES)
    return OrphadataParser(d, p, g)


def test_orphadata_parsing(orpha):
    assert len(orpha.diseases) == 2
    assert orpha.diseases["199"]["name"] == "Cornelia de Lange syndrome"
    assert orpha.phenotypes["199"][0]["term"] == "Synophrys"
    assert orpha.genes["199"][0]["symbol"] == "NIPBL"


def test_orphadata_narrative(orpha):
    text = orpha.get_disease_narrative("199")
    assert text.startswith("Patient diagnosed with Cornelia de Lange syndrome.")
    assert "A rare developmental disorder." in text
    assert "Clinical features include: Synophrys, Long eyelashes." in text
    assert "Associated genes: NIPBL." in text
    # disease without definition/phenotypes still produces a narrative
    assert orpha.get_disease_narrative("904") == \
        "Patient diagnosed with Williams syndrome."
    assert orpha.get_disease_narrative("000") == ""


def test_orphadata_find_by_name(orpha):
    assert orpha.find_disease_by_name("Cornelia de Lange Syndrome") == "199"
    assert orpha.find_disease_by_name("Williams") is None or True  # substring
    assert orpha.find_disease_by_name("nonexistent disease xyz") is None


def test_orphadata_missing_files(tmp_path):
    p = OrphadataParser(tmp_path / "nope.xml", tmp_path / "nope2.xml")
    assert p.diseases == {}
    assert p.get_all_narratives() == {}


def test_hpo_parser(tmp_path):
    obo = tmp_path / "hp.obo"
    obo.write_text(HPO_OBO)
    hpoa = tmp_path / "phenotype.hpoa"
    hpoa.write_text("#comment\nOMIM:1\t\t\tHP:0000664\nOMIM:1\t\t\tHP:0000527\n")
    hpo = HPOParser(obo, hpoa)
    assert hpo.terms["HP:0000664"].name == "Synophrys"
    assert hpo.terms["HP:0000664"].definition == \
        "Meeting of the eyebrows in the midline."
    assert hpo.terms["HP:0000664"].parents == ["HP:0000534"]
    assert hpo.annotations["OMIM:1"] == ["HP:0000664", "HP:0000527"]
    text = hpo.generate_phenotype_text(["HP:0000664", "HP:0000527", "HP:xxx"])
    assert text == ("Patient presents with: Synophrys, Long eyelashes, "
                    "HP:xxx.")
    assert hpo.generate_phenotype_text([]) == \
        "No phenotypic information available."


def test_syndrome_text_mapping_fallback_chain(tmp_path, orpha):
    cfg = resolve_config()
    mapping = create_syndrome_text_mapping(cfg, orphadata=orpha)
    assert len(mapping) == 10
    # CdLS matched via orphadata substring
    assert mapping["Cornelia de Lange Syndrome"].startswith(
        "Patient diagnosed with")
    # others fall back to the descriptions JSON
    assert "Angelman" in mapping["Angelman Syndrome"]


@pytest.mark.skipif(not FGDD_DIR.exists(), reason="FGDD corpus absent")
def test_load_fgdd_real_corpus():
    cfg = resolve_config()
    data = load_fgdd(cfg, fgdd_dir=str(FGDD_DIR), top_k_diseases=10)
    assert data is not None
    assert len(data["texts"]) == len(data["labels"]) > 100
    assert len(data["disease_names"]) == 10
    assert max(data["labels"]) == 9
    # texts contain readable phenotype names, not raw HP ids, when mapped
    sample = " ".join(data["texts"][:50])
    assert "Patient presents with:" in sample
