"""British→American spelling mapping for WER-scoring normalization.

The reference scores WER through openai-whisper's ``EnglishTextNormalizer``
(``lcasr/run.py:8-9``), whose final step maps British spellings to American
via the ~1.7k-entry ``english.json`` table.  That file is not shipped in this
image, so the table is regenerated here from curated stem lists + the same
morphological families the original covers (-ise/-ize, -our/-or, -re/-er,
-ogue/-og, -ll-/-l-, ae/oe→e, -ence/-ense, -amme/-am, plus irregulars).

Notes on safety: the mapping is applied identically to hypothesis AND gold,
so over-coverage cannot skew WER — only a missing entry can (a British gold
vs an American hypothesis scores a substitution).  Keys are whole words
(the spelling normalizer replaces word-by-word), so none of these fire on
substrings.  Words valid in BOTH dialects with distinct meaning (disc/disk,
vice/vise, grille) are deliberately excluded, matching the original table.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict

# verbs taking British -ise → American -ize; stem is the part before "ise".
# expansion: -ise, -ised, -iser(s), -ises, -ising, -isation(s), -isable
_ISE_STEMS = """
agon alphabet amort anaesthet anonym antagon apolog appet author automat
bapt brutal burglar capital carbon categor cauter central character civil
collateral colon commercial computer criminal critic crystall custom
decimal decolon decriminal dehuman demilitar demobil democrat demonet
demoral deodor depersonal depressur destabil digit disorgan dramat econom
editorial empathi emphas energ epitom equal eulog evangel extempor
factor familiar fantas fertil fictional final fluid formal fossil fratern
fundra galvan general ghetto glamor global harmon homogen hospital human
hybrid hypnot hypothes ideal idol immobil immortal immun incentiv
individual industrial initial institutional internal international
italic itemi jeopard journal legal legitim liberal lion local magnet
marginal material maxim mechan memor mesmer metabol militar miniatur
minim mobil modern monetar monopol moral motor mythologi national natural
neutral normal optim organ ostrac oxid particular pasteur patron penal
personal philosoph plagiar polar polit popular priorit privat
professional pulver radical random rational real recogn rhapsod
revolution ridicul roman romantic sanit satir scandal scrutin secular
sensational sensit sentimental serial social special specif stabil
standard steril stigmat subsid summar symbol sympath synchron synthes
systemat tantal temporal terror theor tranquill traumat trivial tyrann
urban util utter vandal vapor verbal victim visual vocal vulgar western
winter womani public
""".split()

# -yse → -yze verbs
_YSE_STEMS = "anal breathal catal dial electrol hydrol paral psychoanal".split()

# nouns with British -our → American -or; expansion: -our(s), -oured,
# -ouring, -ourite(s), -ourable, -ourably, -ourful, -ourless, -ourer(s)
_OUR_STEMS = """
arb ard arm behavi beladd cand clam col demean dishon dol enam endeav fav
ferv flav harb hon hum lab misbehavi misdemean neighb od parl ranc rig rum
sav savi splend succ tum val vap vig
""".split()

# British -re → American -er; expansion: -re(s), -red, -ring where sensible
_RE_WORDS = """
calibre centre centimetre epicentre fibre goitre kilometre litre lustre
manoeuvre meagre metre micrometre millilitre millimetre mitre nitre ochre
reconnoitre sabre saltpetre sceptre sepulchre sombre spectre theatre titre
amphitheatre lacklustre louvre
""".split()

# British -ogue → American -og
_OGUE_WORDS = "analogue catalogue dialogue epilogue homologue monologue prologue travelogue".split()

# British doubled-l inflections → single l.  base verbs whose -ed/-ing/-er
# forms double the l in British English
_LL_VERBS = """
apparel barrel bevel cancel carol cavil channel chisel counsel cudgel dial
dishevel drivel duel enamel equal fuel funnel gambol gravel grovel imperil
initial jewel kennel kernel label level libel marshal marvel medal model
panel parcel pedal pencil peril pummel quarrel ravel refuel remodel revel
rival shovel shrivel signal snivel spiral squirrel stencil swivel tassel
total towel trammel travel trowel tunnel unravel weasel yodel
""".split()

_IRREGULAR = {
    # feminine/greek ae, oe → e
    "anaemia": "anemia", "anaemic": "anemic",
    "anaesthesia": "anesthesia", "anaesthetic": "anesthetic",
    "anaesthetics": "anesthetics", "anaesthetist": "anesthetist",
    "caesium": "cesium", "coeliac": "celiac",
    "diarrhoea": "diarrhea", "dyspnoea": "dyspnea",
    "encyclopaedia": "encyclopedia", "encyclopaedias": "encyclopedias",
    "faeces": "feces", "foetal": "fetal", "foetus": "fetus",
    "foetuses": "fetuses", "gonorrhoea": "gonorrhea",
    "gynaecologist": "gynecologist", "gynaecology": "gynecology",
    "haematology": "hematology", "haemoglobin": "hemoglobin",
    "haemophilia": "hemophilia", "haemorrhage": "hemorrhage",
    "haemorrhages": "hemorrhages", "haemorrhoid": "hemorrhoid",
    "haemorrhoids": "hemorrhoids", "leukaemia": "leukemia",
    "mediaeval": "medieval", "oedema": "edema",
    "oesophagus": "esophagus", "oestrogen": "estrogen",
    "orthopaedic": "orthopedic", "orthopaedics": "orthopedics",
    "paediatric": "pediatric", "paediatrician": "pediatrician",
    "paediatricians": "pediatricians", "paediatrics": "pediatrics",
    "palaeontologist": "paleontologist", "palaeontology": "paleontology",
    "primaeval": "primeval", "septicaemia": "septicemia",
    # -ence → -ense (nouns)
    "defence": "defense", "defences": "defenses",
    "defenceless": "defenseless",
    "offence": "offense", "offences": "offenses",
    "licence": "license", "licences": "licenses",
    "pretence": "pretense", "pretences": "pretenses",
    # -amme → -am
    "programme": "program", "programmes": "programs",
    "gramme": "gram", "grammes": "grams",
    "kilogramme": "kilogram", "kilogrammes": "kilograms",
    # single/double l stems
    "enrol": "enroll", "enrols": "enrolls", "enrolment": "enrollment",
    "enrolments": "enrollments",
    "fulfil": "fulfill", "fulfils": "fulfills",
    "fulfilment": "fulfillment", "fulfilments": "fulfillments",
    "instalment": "installment", "instalments": "installments",
    "distil": "distill", "distils": "distills",
    "instil": "instill", "instils": "instills",
    "enthral": "enthrall", "enthrals": "enthralls",
    "appal": "appall", "appals": "appalls",
    "skilful": "skillful", "skilfully": "skillfully",
    "wilful": "willful", "wilfully": "willfully",
    "tranquillity": "tranquility",
    "tranquillise": "tranquilize", "tranquillised": "tranquilized",
    "tranquilliser": "tranquilizer", "tranquillisers": "tranquilizers",
    "jewellery": "jewelry", "woollen": "woolen", "woolly": "wooly",
    "counsellor": "counselor", "counsellors": "counselors",
    "chancellor": "chancellor",  # unchanged (guard against over-derivation)
    "marvellous": "marvelous", "marvellously": "marvelously",
    "gruelling": "grueling",
    "cancellation": "cancellation",  # ll retained in American
    # misc irregulars
    "neighbourhood": "neighborhood", "neighbourhoods": "neighborhoods",
    "aeon": "eon", "aeons": "eons",
    "aeroplane": "airplane", "aeroplanes": "airplanes",
    "ageing": "aging",
    "aluminium": "aluminum",
    "annexe": "annex",
    "artefact": "artifact", "artefacts": "artifacts",
    "behove": "behoove",
    "carburettor": "carburetor", "carburettors": "carburetors",
    "cheque": "check", "cheques": "checks",
    "chequebook": "checkbook", "chequebooks": "checkbooks",
    "chequered": "checkered",
    "chilli": "chili", "chillies": "chilies",
    "connexion": "connection",
    "cosy": "cozy", "cosier": "cozier", "cosiest": "coziest",
    "cypher": "cipher", "cyphers": "ciphers",
    "doughnut": "donut", "doughnuts": "donuts",
    "draught": "draft", "draughts": "drafts", "draughty": "drafty",
    "draughtsman": "draftsman",
    "focussed": "focused", "focusses": "focuses", "focussing": "focusing",
    "gaol": "jail", "gaols": "jails",
    "grey": "gray", "greyed": "grayed", "greyish": "grayish",
    "greys": "grays",
    "judgement": "judgment", "judgements": "judgments",
    "kerb": "curb", "kerbs": "curbs",
    "manoeuvre": "maneuver", "manoeuvres": "maneuvers",
    "manoeuvred": "maneuvered", "manoeuvring": "maneuvering",
    "mollusc": "mollusk", "molluscs": "mollusks",
    "mould": "mold", "moulded": "molded", "moulding": "molding",
    "moulds": "molds", "mouldy": "moldy",
    "moult": "molt", "moulted": "molted", "moulting": "molting",
    "moustache": "mustache", "moustaches": "mustaches",
    "nought": "naught",
    "omelette": "omelet", "omelettes": "omelets",
    "orientated": "oriented", "orientate": "orient",
    "paralyse": "paralyze",  # also in _YSE_STEMS; harmless duplicate
    "plough": "plow", "ploughed": "plowed", "ploughing": "plowing",
    "ploughs": "plows", "snowplough": "snowplow",
    "practise": "practice", "practised": "practiced",
    "practises": "practices", "practising": "practicing",
    "pyjama": "pajama", "pyjamas": "pajamas",
    "sceptic": "skeptic", "sceptical": "skeptical",
    "sceptically": "skeptically", "scepticism": "skepticism",
    "sceptics": "skeptics",
    "smoulder": "smolder", "smouldered": "smoldered",
    "smouldering": "smoldering",
    "speciality": "specialty", "specialities": "specialties",
    "spelt": "spelled",
    "storey": "story", "storeys": "stories",
    "sulphate": "sulfate", "sulphates": "sulfates",
    "sulphide": "sulfide", "sulphides": "sulfides",
    "sulphur": "sulfur", "sulphuric": "sulfuric",
    "titbit": "tidbit", "titbits": "tidbits",
    "tsar": "czar", "tsars": "czars",
    "tyre": "tire", "tyres": "tires",
    "yoghurt": "yogurt", "yoghurts": "yogurts",
    "yoghourt": "yogurt",
}


def _expand_ise(stem: str, out: Dict[str, str]):
    pairs = (
        ("ise", "ize"), ("ised", "ized"), ("iser", "izer"), ("isers", "izers"),
        ("ises", "izes"), ("ising", "izing"),
        ("isation", "ization"), ("isations", "izations"),
        ("isable", "izable"),
    )
    for b, a in pairs:
        out[stem + b] = stem + a


def _expand_our(stem: str, out: Dict[str, str]):
    pairs = (
        ("our", "or"), ("ours", "ors"), ("oured", "ored"),
        ("ouring", "oring"), ("ourite", "orite"), ("ourites", "orites"),
        ("ourable", "orable"), ("ourably", "orably"),
        ("ourful", "orful"), ("ourless", "orless"),
        ("ourer", "orer"), ("ourers", "orers"),
        ("oural", "oral"), ("ourally", "orally"),  # behavioural(ly)
        ("oury", "ory"), ("ouries", "ories"),  # savoury/savouries
    )
    for b, a in pairs:
        out[stem + b] = stem + a


def _expand_re(word: str, out: Dict[str, str]):
    am = word[:-2] + "er"
    out[word] = am
    out[word + "s"] = am + "s"
    out[word[:-2] + "red"] = am + "ed"


def _expand_ogue(word: str, out: Dict[str, str]):
    am = word[:-2]  # drop "ue"
    out[word] = am
    out[word + "s"] = am + "s"
    out[word + "d"] = am + "ed"
    out[word[:-2] + "uing"] = am + "ing"


def _expand_ll(verb: str, out: Dict[str, str]):
    pairs = (
        ("led", "ed"), ("ling", "ing"), ("ler", "er"), ("lers", "ers"),
    )
    for b, a in pairs:
        out[verb + "l" + b[1:]] = verb + a  # e.g. travel+"led" → travel+"ed"


@lru_cache(maxsize=1)
def english_spelling_mapping() -> Dict[str, str]:
    """The British→American whole-word mapping, ~1.5k entries."""
    out: Dict[str, str] = {}
    for stem in _ISE_STEMS:
        _expand_ise(stem, out)
    for stem in _YSE_STEMS:
        for b, a in (("yse", "yze"), ("ysed", "yzed"), ("yses", "yzes"),
                     ("ysing", "yzing"), ("yser", "yzer"), ("ysers", "yzers")):
            out[stem + b] = stem + a
    for stem in _OUR_STEMS:
        _expand_our(stem, out)
    for word in _RE_WORDS:
        _expand_re(word, out)
    for word in _OGUE_WORDS:
        _expand_ogue(word, out)
    for verb in _LL_VERBS:
        _expand_ll(verb, out)
    out.update(_IRREGULAR)
    # identity entries are guards, not mappings — drop them
    return {k: v for k, v in out.items() if k != v}
