"""Bundled pairwise token language identification.

The reference classifies script-ambiguous tokens with a langid model
constrained to the two target languages (the reference `mix_count.py:
30-37,111`). langid's pretrained model is not a dependency of this package,
so this module bundles a small, dependency-free discriminative model for
the Latin-script languages the pipeline supports (EN, FR, ES, PT, IT, DE,
NL, ID, VI). It is *pairwise by construction* — like the reference's
``ident.set_languages([lang1, lang2])`` — which makes the problem far
easier than open-set LID: evidence only needs to separate the two
candidates.

Evidence, strongest first:

1. **Lexicon**: the most frequent function/query words per language
   (determiners, prepositions, question words, auxiliaries — the tokens
   that dominate mMARCO-style queries). A word found in exactly one of
   the pair's lexicons decides immediately.
2. **Characters**: diacritics and letters distinctive *within the pair*
   (e.g. ``é`` decides FR over EN but is mute for FR vs ES; ``ß`` decides
   DE; Vietnamese tone marks decide VI).
3. **Affixes**: suffix/prefix patterns distinctive within the pair
   (``-ção`` PT vs ``-ción`` ES; ``-ung``/``-keit`` DE; ``-zione`` IT).

Ties (no distinguishing evidence) return ``None`` so the caller applies
its own convention — ``count_two_langs`` falls back to ``lang_a``, the
behavior it always had for classifier-less same-script pairs.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Lexicons: high-frequency function + query-domain words. Deliberately
# conservative — a word ambiguous WITHIN a likely pair (EN-DE "die",
# "war"; EN-FR/ES/IT "a") may appear in several lexicons; pair scoring
# neutralizes shared entries automatically.
# ---------------------------------------------------------------------------

_LEXICON: Dict[str, frozenset] = {
    "en": frozenset("""
        the of and to in is was for that what where which who whom how when
        why did does do can could will would should are were be been being
        have has had not with from by on at as it this these those a an or
        but if then there here you your yours he she they we i me my mine
        his her hers their theirs our ours its about into over under between
        during before after above below up down out off again further once
        all any both each few more most other some such no nor only own same
        so than too very just also now new old many much number average
        define definition meaning mean means cost salary phone county state
        city country year years age long tall big small first last next good
        best worst take takes took get gets got make makes made come comes
        came go goes went
    """.split()),
    "fr": frozenset("""
        le la les de des du un une et est sont que qui quoi où quand comment
        pourquoi quel quelle quels quelles dans pour par sur avec sans ce
        cette ces cet il elle ils elles nous vous je tu on mon ma mes ton ta
        tes son sa ses leur leurs notre nos votre vos ne pas plus moins très
        bien fait faire être avoir à au aux en y combien signifie définition
        moyenne coût salaire numéro téléphone comté état ville pays année
        années âge grand petit premier dernier prochain bon meilleur prend
        était étaient peut peuvent doit doivent aussi comme mais ou si alors
        lorsque depuis entre pendant avant après chez vers
    """.split()),
    "es": frozenset("""
        el la los las de del un una unos unas y es son que qué quién quiénes
        dónde cuándo cómo cuál cuáles por para con sin en sobre este esta
        estos estas ese esa esos esas yo tú él ella ellos ellas nosotros
        usted ustedes su sus mi mis tu tus no sí más menos muy bien hace
        hacer ser estar tiene tienen hay cuánto cuántos cuánta cuántas
        significa definición promedio costo salario número teléfono condado
        estado ciudad país año años edad grande pequeño primero último
        próximo bueno mejor toma era eran puede pueden debe deben también
        como pero o si entonces cuando desde entre durante antes después
        hacia
    """.split()),
    "pt": frozenset("""
        o os as de do da dos das um uma uns umas e é são que quem onde
        quando como qual quais por para com sem em no na nos nas este esta
        estes estas esse essa isso ele ela eles elas nós você vocês seu sua
        seus suas meu minha meus minhas não sim mais menos muito bem faz
        fazer ser estar tem têm há quanto quantos quanta quantas significa
        definição média custo salário número telefone condado estado cidade
        país ano anos idade grande pequeno primeiro último próximo bom
        melhor toma era eram pode podem deve devem também mas ou se então
        desde entre durante antes depois até
    """.split()),
    "it": frozenset("""
        il lo la i gli le di del della dei delle dello un uno una e è sono
        che chi dove quando come perché quale quali per con senza in su
        questo questa questi queste quello quella lui lei loro noi voi io tu
        mio mia miei mie suo sua suoi sue non sì più meno molto bene fa fare
        essere avere ha hanno quanto quanti quanta quante significa
        definizione media costo stipendio numero telefono contea stato città
        paese anno anni età grande piccolo primo ultimo prossimo buono
        migliore prende era erano può possono deve devono anche ma o se
        allora da tra fra durante prima dopo verso nel nella negli alle
    """.split()),
    "de": frozenset("""
        der die das den dem des ein eine einen einem einer eines und ist
        sind war waren dass wer wo wann wie warum was welche welcher welches
        für mit ohne in im auf an am zu zum zur von vom bei nach über unter
        nicht ja mehr weniger sehr gut hat haben sein werden wird wurde
        können kann muss müssen soll sollen viele wie bedeutet definition
        durchschnitt kosten gehalt nummer telefon landkreis bundesland stadt
        land jahr jahre alter groß klein erste letzte nächste gute beste
        nimmt auch aber oder wenn dann als seit zwischen während vor nach
        durch gegen ich du er sie es wir ihr mein dein ihre ihrem unserer
    """.split()),
    "nl": frozenset("""
        de het een en is zijn was waren dat wie waar wanneer hoe waarom wat
        welke voor met zonder in op aan bij van naar over onder niet ja meer
        minder zeer goed heeft hebben wordt werd kan kunnen moet moeten veel
        hoeveel betekent definitie gemiddelde kosten salaris nummer telefoon
        provincie stad land jaar jaren leeftijd groot klein eerste laatste
        volgende goede beste neemt ook maar of als dan sinds tussen tijdens
        voordat nadat door tegen ik jij hij zij wij jullie mijn jouw zijn
        haar hun onze
    """.split()),
    "id": frozenset("""
        yang dan di ke dari untuk dengan pada adalah itu ini tidak ya apa
        siapa dimana mana kapan bagaimana mengapa kenapa berapa jumlah arti
        definisi rata-rata biaya gaji nomor telepon kabupaten provinsi kota
        negara tahun umur besar kecil pertama terakhir berikutnya baik
        terbaik juga tetapi atau jika maka sejak antara selama sebelum
        sesudah oleh terhadap saya kamu dia mereka kami kita bisa dapat
        harus akan sudah belum ada
    """.split()),
    "vi": frozenset("""
        là và của cho với trong trên không có gì ai đâu khi nào như thế tại
        sao bao nhiêu nghĩa định trung bình chi phí lương số điện thoại
        quận tỉnh thành phố nước năm tuổi lớn nhỏ đầu cuối tiếp tốt nhất
        cũng nhưng hoặc nếu thì từ giữa trước sau bởi tôi bạn anh chị họ
        chúng được phải sẽ đã chưa một hai những các này đó
    """.split()),
}

# ---------------------------------------------------------------------------
# Character evidence: codepoints (or (lo, hi) ranges) characteristic of a
# language. Shared diacritics (é in FR/ES/PT/IT) appear under every owner;
# pair scoring cancels them unless only one side of the pair claims them.
# ---------------------------------------------------------------------------

_CHAR_HINTS: Dict[str, Tuple] = {
    "fr": ("à", "â", "è", "é", "ê", "ë", "î", "ï", "ô", "û", "ù", "ç", "œ"),
    "es": ("á", "é", "í", "ó", "ú", "ñ", "ü", "¿", "¡"),
    "pt": ("ã", "õ", "á", "â", "à", "é", "ê", "í", "ó", "ô", "ú", "ç"),
    "it": ("à", "è", "é", "ì", "ò", "ù"),
    "de": ("ä", "ö", "ü", "ß"),
    "nl": (),
    "id": (),
    "en": (),
    # Vietnamese: base extras + the whole Latin Extended Additional tone
    # block (0x1EA0-0x1EF9 covers ạ ả ấ ầ ... ỹ)
    "vi": ("ă", "â", "đ", "ê", "ô", "ơ", "ư", (0x1EA0, 0x1EF9)),
}

# ---------------------------------------------------------------------------
# Affix evidence: (suffixes, prefixes) distinctive per language.
# ---------------------------------------------------------------------------

_SUFFIX_HINTS: Dict[str, Tuple[str, ...]] = {
    "en": ("ing", "ness", "ship", "ly"),
    "fr": ("eur", "eure", "euse", "eux", "aise", "ment", "ique", "ité",
           "aux", "erie"),
    "es": ("ción", "dad", "miento", "mente", "idad"),
    "pt": ("ção", "dade", "mento", "mente", "ão", "ões"),
    "it": ("zione", "ità", "mento", "issimo", "aggio"),
    "de": ("ung", "keit", "heit", "lich", "isch", "chen", "schaft", "tät"),
    "nl": ("heid", "lijk", "tje", "sche"),
    "id": ("kan", "nya", "lah"),
    "vi": (),
}

_LEXICON_W, _CHAR_W, _SUFFIX_W = 4, 2, 1


def _char_score(token: str, lang: str) -> int:
    hints = _CHAR_HINTS.get(lang, ())
    score = 0
    for ch in token:
        cp = ord(ch)
        for h in hints:
            if isinstance(h, tuple):
                if h[0] <= cp <= h[1]:
                    score += 1
                    break
            elif ch == h:
                score += 1
                break
    return score


def _evidence(token_lower: str, lang: str) -> int:
    score = 0
    if token_lower in _LEXICON.get(lang, frozenset()):
        score += _LEXICON_W
    score += _CHAR_W * _char_score(token_lower, lang)
    for suf in _SUFFIX_HINTS.get(lang, ()):
        if len(token_lower) > len(suf) + 1 and token_lower.endswith(suf):
            score += _SUFFIX_W
            break
    return score


def classify_pair(token: str, lang_a: str, lang_b: str) -> Optional[str]:
    """Classify one token between exactly two languages.

    Returns ``lang_a``/``lang_b``, or ``None`` when the evidence does not
    separate them (the caller's tie convention applies — the reference's
    langid always emits a label; ours is honest about ties instead).
    """
    t = token.lower()
    sa, sb = _evidence(t, lang_a), _evidence(t, lang_b)
    if sa > sb:
        return lang_a
    if sb > sa:
        return lang_b
    return None


def supported(lang: str) -> bool:
    return lang in _LEXICON


def default_pair_classifier(
    lang_a: str, lang_b: str
) -> Optional[Callable[[str], str]]:
    """A ``classifier(token) -> lang`` hook for ``count_two_langs``,
    or ``None`` when either language has no bundled model.

    Ties resolve to ``lang_a`` — identical to what classifier-less
    counting did, so enabling the default can only *improve* same-script
    discrimination, never change script-decided counts.
    """
    if not (supported(lang_a) and supported(lang_b)):
        return None

    def _clf(token: str) -> str:
        return classify_pair(token, lang_a, lang_b) or lang_a

    return _clf
